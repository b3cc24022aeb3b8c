"""Test toolkit shipped with the package: counterpart of
``mxnet_tpu/test_utils.py``.

Reference: python/mxnet/test_utils.py — assert_almost_equal (:470),
check_numeric_gradient finite-difference oracle (:790), check_consistency
cross-context oracle (:1204), rand_ndarray (:339), default_context (:53).

The same oracle pattern: the host is ground truth for the card, and
finite differences are ground truth for autograd. Arrays are built on
the context a call is given, else on ``default_context()``, which is the
current context (``gpu(0)`` unless the caller asks for the CPU) until
``set_default_context`` names another. On the card an op runs its
kernel: ``check_consistency``, ``check_numeric_gradient`` and
``check_speed`` over ``nd.contrib.flash_attention`` launch K1-K3.
"""
from __future__ import annotations

import numpy as np

from . import context as _context
from . import ndarray as nd
from . import autograd

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
    "rand_shape_nd", "check_numeric_gradient", "check_consistency",
    "same", "retry", "check_speed", "count_dispatches"]


class count_dispatches:
    """Count executable launches inside a ``with`` block.

    Counts every operator dispatch (``ops.registry.DISPATCHES``: each
    ``invoke_raw`` call, a bound executor's ops and the fused-update
    path's coalesced applies).

    ::

        with count_dispatches() as c:
            trainer.step(1)
        assert c.count <= expected
    """

    def __enter__(self):
        from .ops import registry as _reg

        self._start = _reg.DISPATCHES[0]
        self.count = 0
        return self

    def __exit__(self, *exc):
        from .ops import registry as _reg

        self.count = _reg.DISPATCHES[0] - self._start
        return False

_default_ctx = None


def default_context():
    global _default_ctx
    return _default_ctx or _context.current_context()


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def _dtype_tol(dtype):
    dt = np.dtype(dtype)
    if dt == np.float16:
        return 1e-2, 1e-2
    if dt == np.float32:
        return 1e-4, 1e-5
    if dt == np.float64:
        return 1e-7, 1e-9
    return 0, 0


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def almost_equal(a, b, rtol=None, atol=None):
    a = a.asnumpy() if isinstance(a, nd.NDArray) else np.asarray(a)
    b = b.asnumpy() if isinstance(b, nd.NDArray) else np.asarray(b)
    if rtol is None or atol is None:
        r, t = _dtype_tol(a.dtype)
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else t
    return np.allclose(a, b, rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np = a.asnumpy() if isinstance(a, nd.NDArray) else np.asarray(a)
    b_np = b.asnumpy() if isinstance(b, nd.NDArray) else np.asarray(b)
    if rtol is None or atol is None:
        r, t = _dtype_tol(a_np.dtype)
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else t
    if not np.allclose(a_np, b_np, rtol=rtol, atol=atol):
        idx = np.unravel_index(np.argmax(np.abs(a_np - b_np)), a_np.shape) \
            if a_np.shape else ()
        raise AssertionError(
            "%s and %s differ: max |diff|=%g at %s (%s vs %s), rtol=%g atol=%g"
            % (names[0], names[1], float(np.max(np.abs(a_np - b_np))), idx,
               a_np[idx] if a_np.shape else a_np, b_np[idx] if b_np.shape else b_np,
               rtol, atol))


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=np.float32,
                 ctx=None):
    """Uniform [-1, 1) values on `ctx` (default: ``default_context()``);
    a sparse `stype` (``row_sparse``, ``csr``) zeroes entries beyond
    `density` and converts there."""
    arr = np.random.uniform(-1, 1, size=shape).astype(dtype)
    if stype != "default" and density is not None:
        mask = np.random.uniform(0, 1, size=shape) < density
        arr = arr * mask
    out = nd.array(arr, ctx=ctx or default_context())
    if stype != "default":
        return out.tostype(stype)
    return out


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3,
                           argnums=None, ctx=None):
    """Finite-difference check of autograd gradients (reference:
    test_utils.py:790).

    fn: callable taking NDArrays, returning a scalar-reducible NDArray.
    inputs: list of numpy arrays (float32 recommended).
    ctx: where every array is built (default: ``default_context()``).
    """
    ctx = ctx or default_context()
    nds = [nd.array(x.astype(np.float64).astype(np.float32), ctx=ctx)
           for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = fn(*nds)
        loss = out.sum()
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in nds]

    check = range(len(inputs)) if argnums is None else argnums
    for i in check:
        x = inputs[i].astype(np.float32)
        numeric = np.zeros_like(x, dtype=np.float64)
        it = np.nditer(x, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            xp = x.copy(); xp[idx] += eps
            xm = x.copy(); xm[idx] -= eps
            args_p = [nd.array(inputs[j].astype(np.float32), ctx=ctx)
                      if j != i else nd.array(xp, ctx=ctx)
                      for j in range(len(inputs))]
            args_m = [nd.array(inputs[j].astype(np.float32), ctx=ctx)
                      if j != i else nd.array(xm, ctx=ctx)
                      for j in range(len(inputs))]
            fp = float(fn(*args_p).sum().asscalar())
            fm = float(fn(*args_m).sum().asscalar())
            numeric[idx] = (fp - fm) / (2 * eps)
            it.iternext()
        assert_almost_equal(analytic[i], numeric.astype(np.float32),
                            rtol=rtol, atol=atol,
                            names=("autograd[%d]" % i, "numeric[%d]" % i))


def check_consistency(fn, arg_arrays, ctx_list=None, rtol=1e-4, atol=1e-5):
    """Run `fn` on arrays built on each context and cross-compare
    outputs (reference oracle pattern: test_utils.py:1204 — the host is
    ground truth for the card)."""
    if ctx_list is None:
        ctx_list = [_context.cpu(0), default_context()]
    outs = []
    for ctx in ctx_list:
        args = [nd.array(a, ctx=ctx) for a in arg_arrays]
        out = fn(*args)
        outs.append(out.asnumpy())
    for o in outs[1:]:
        assert_almost_equal(outs[0], o, rtol=rtol, atol=atol)
    return outs


def retry(n=3):
    def deco(test_fn):
        def wrapped(*args, **kwargs):
            last = None
            for _ in range(n):
                try:
                    return test_fn(*args, **kwargs)
                except AssertionError as e:
                    last = e
            raise last

        return wrapped

    return deco


def check_speed(sym, location=None, ctx=None, N=20, grad_req=None,
                typ="whole", **kwargs):
    """Average seconds per forward(+backward) of a bound symbol
    (reference test_utils.py:check_speed). ``kwargs`` are input shapes
    for simple_bind when `location` is not given. The executor is bound
    on `ctx` (default: ``default_context()``); each timing ends with
    ``nd.waitall()``, so a card's queued work is inside it."""
    import time

    ctx = ctx or default_context()
    if grad_req is None:
        grad_req = "write"
    if location is None:
        exe = sym.simple_bind(grad_req=grad_req, ctx=ctx, **kwargs)
        location = {k: np.random.normal(size=arr.shape, scale=1.0)
                    for k, arr in exe.arg_dict.items()}
    else:
        assert isinstance(location, dict), \
            'Expect dict, get "location"=%s' % str(location)
        exe = sym.simple_bind(grad_req=grad_req, ctx=ctx,
                              **{k: v.shape for k, v in location.items()})
    for name, iarr in location.items():
        exe.arg_dict[name][:] = iarr     # __setitem__ casts to dtype

    if typ == "whole":
        exe.forward(is_train=True)
        exe.backward(out_grads=exe.outputs)
        nd.waitall()
        tic = time.perf_counter()
        for _ in range(N):
            exe.forward(is_train=True)
            exe.backward(out_grads=exe.outputs)
        nd.waitall()
        return (time.perf_counter() - tic) / N
    if typ == "forward":
        exe.forward(is_train=False)
        nd.waitall()
        tic = time.perf_counter()
        for _ in range(N):
            exe.forward(is_train=False)
        nd.waitall()
        return (time.perf_counter() - tic) / N
    raise ValueError("typ can only be 'whole' or 'forward', got %r" % typ)
