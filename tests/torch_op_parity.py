"""Shared helper of ``test_torch_linalg.py`` and
``test_torch_contrib_tail.py``: one registered operator through each
package's imperative dispatch (the JAX package's on the CPU, the port's
with ``ctx=mx.cpu()``) on the same numpy inputs, forward and, under
``autograd.record()``, the gradients of chosen inputs for chosen head
gradients on chosen outputs. Imported through pytest's rootdir
insertion, as ``torch_zoo_parity.py``.
"""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import _invoke as j_invoke

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray.ndarray import _invoke as t_invoke


def _run(pkg, invoke, name, inputs, attrs, wrt, heads, ctx):
    kw = {} if ctx is None else {"ctx": ctx}
    arrays = [pkg.nd.array(x, dtype=x.dtype, **kw) for x in inputs]
    for i in wrt:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = invoke(name, arrays, **attrs)
    outs = list(out) if isinstance(out, tuple) else [out]
    if wrt:
        pkg.autograd.backward([outs[k] for k in heads],
                              [pkg.nd.array(h, **kw) for h in
                               head_values([outs[k].shape for k in heads])])
    return ([o.asnumpy() for o in outs],
            [arrays[i].grad.asnumpy() for i in wrt])


def head_values(shapes, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0.5, 1.5, s).astype(np.float32) for s in shapes]


def both(name, inputs, attrs=None, wrt=(), heads=(0,)):
    """((jax outputs, jax gradients), (port outputs, port gradients)),
    numpy arrays."""
    attrs = attrs or {}
    want = _run(jmx, j_invoke, name, inputs, attrs, wrt, heads, None)
    with mx.cpu():
        got = _run(mx, t_invoke, name, inputs, attrs, wrt, heads, mx.cpu())
    return want, got


def assert_close(got, want, rtol, atol, what=""):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg="%s[%d]" % (what, k))
