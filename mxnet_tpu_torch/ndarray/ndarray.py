"""NDArray — the mutable n-dim array of the port.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray wraps a
``torch.Tensor`` on an explicit device. PyTorch dispatch is already
asynchronous on the card; ``wait_to_read`` waits for the stream the
array was produced on, so a caller that times a result (the serving
worker does) measures the work and not its enqueue.

A write installs a new tensor (or writes in place for ``__setitem__``)
and bumps ``version``, the engine-variable version counter of the
reference (ndarray.py:75-81 in the JAX package).

Gradients: ``attach_grad`` marks the array as a variable of
:mod:`~mxnet_tpu_torch.autograd` (its tensor becomes a leaf of torch's
graph), ``backward`` runs the tape from this array, ``.grad`` is the
gradient buffer and ``detach`` cuts the array out of the graph. Ops
dispatched outside ``autograd.record()`` build no graph (grad mode off),
and ops registered ``differentiable=False`` never do.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import engine as _engine
from ..base import mx_real_t, numpy_dtype, torch_dtype, dtype_name
from ..context import Context, current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "waitall"]


def _producer_stream(tensor):
    return torch.cuda.current_stream(tensor.device) if tensor.is_cuda \
        else None


class NDArray:
    """An n-dimensional array on a device (reference: mx.nd.NDArray)."""

    __slots__ = ("_data", "_ctx", "_stream", "version", "_grad", "_grad_req",
                 "_ag_retired", "_recorded", "__weakref__")

    # Make numpy defer binary ops (np_array + ndarray) to NDArray.
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else Context.of(data.device)
        self._stream = _producer_stream(data)
        self.version = 0
        self._grad = None
        self._grad_req = "null"
        self._ag_retired = []
        self._recorded = False

    # -- engine-var semantics -------------------------------------------------

    def _set_data(self, new_data):
        """Install a new tensor: the write side of the versioned var. A
        marked variable gets the value as a fresh leaf, its old leaf
        kept for a pending backward."""
        if self._grad is not None:
            from .. import autograd

            autograd._retire(self, self._data)
            new_data = new_data.detach().requires_grad_(
                new_data.is_floating_point())
        self._data = new_data
        self._stream = _producer_stream(new_data)
        self.version += 1
        if _engine.is_naive():
            self.wait_to_read()
        return self

    @property
    def data_(self):
        return self._data

    def wait_to_read(self):
        """Block until the work that produced this array has finished."""
        if self._stream is not None:
            self._stream.synchronize()

    wait_to_write = wait_to_read

    # -- basic properties -----------------------------------------------------

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype; the name ``"bfloat16"`` for bfloat16 arrays,
        which numpy cannot represent."""
        name = dtype_name(self._data.dtype)
        return name if name == "bfloat16" else np.dtype(name)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    # -- host transfer --------------------------------------------------------

    def asnumpy(self):
        """Blocking device-to-host copy. bfloat16 widens to float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def __float__(self):
        return float(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(map(str, self.shape)), self._ctx)

    # -- copies / context movement -------------------------------------------

    def copyto(self, other):
        """Copy to another NDArray (which keeps its device) or to a
        Context (a new NDArray there)."""
        data = self._data.detach()
        if isinstance(other, NDArray):
            other._set_data(data.to(other._data.device, copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(data.to(other.torch_device, copy=True),
                           ctx=other)
        raise TypeError("copyto expects NDArray or Context")

    def copy(self):
        """A copy on the same device."""
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def detach(self):
        """The same values, cut out of the autograd graph."""
        return NDArray(self._data.detach(), ctx=self._ctx)

    # -- autograd -------------------------------------------------------------

    @property
    def grad(self):
        return self._grad

    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and mark this array as an autograd
        variable (reference: attach_grad -> MXAutogradMarkVariables)."""
        from .. import autograd

        autograd.mark_variables([self], [zeros(self.shape, ctx=self._ctx,
                                               dtype=self._data.dtype)],
                                grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return _invoke("cast", [self], dtype=dtype_name(dtype))

    # -- shape ops ------------------------------------------------------------

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _invoke("reshape", [self], shape=tuple(shape))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", [self], axes=tuple(axes) if axes else None)

    def flatten(self):
        return _invoke("flatten", [self])

    def relu(self):
        return _invoke("relu", [self])

    def softmax(self, axis=-1):
        return _invoke("softmax", [self], axis=axis)

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", [self], axis=axis)

    def sum(self, axis=None, keepdims=False):
        return _invoke("sum", [self], axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _invoke("mean", [self], axis=axis, keepdims=keepdims)

    def dot(self, other):
        return _invoke("dot", [self, other])

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", [self], ord=ord, axis=axis, keepdims=keepdims)

    def clip(self, a_min=None, a_max=None):
        return _invoke("clip", [self], a_min=a_min, a_max=a_max)

    def square(self):
        return _invoke("square", [self])

    def sqrt(self):
        return _invoke("sqrt", [self])

    # -- arithmetic -----------------------------------------------------------

    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    __radd__ = __add__

    def __iadd__(self, other):
        return self._set_data(self.__add__(other)._data)

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binary_r("broadcast_sub", "_rminus_scalar", self, other)

    def __isub__(self, other):
        return self._set_data(self.__sub__(other)._data)

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    __rmul__ = __mul__

    def __imul__(self, other):
        return self._set_data(self.__mul__(other)._data)

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binary_r("broadcast_div", "_rdiv_scalar", self, other)

    def __itruediv__(self, other):
        return self._set_data(self.__truediv__(other)._data)

    def __neg__(self):
        return _invoke("negative", [self])

    def __hash__(self):
        return id(self)

    # -- indexing -------------------------------------------------------------

    @staticmethod
    def _convert_index(key):
        if isinstance(key, NDArray):
            return key._data
        if isinstance(key, tuple):
            return tuple(NDArray._convert_index(k) for k in key)
        if isinstance(key, list):
            return torch.as_tensor(np.array(key))
        return key

    def __getitem__(self, key):
        """A view, recorded (and differentiable) under ``record()`` as
        the reference routes it through its ``_index`` op."""
        from .. import autograd

        graph = autograd.builds_graph()
        if graph and autograd.is_recording():
            autograd._make_leaf(self)
        with torch.set_grad_enabled(graph):
            out = NDArray(self._data[self._convert_index(key)], ctx=self._ctx)
        out._recorded = graph
        return out

    def __setitem__(self, key, value):
        """In-place write into this array's tensor (bumps ``version``);
        never recorded."""
        if isinstance(value, NDArray):
            value = value._data.detach().to(self._data.device)
        elif isinstance(value, (list, tuple, np.ndarray)):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        with torch.no_grad():
            self._data[self._convert_index(key)] = value
        self._stream = _producer_stream(self._data)
        self.version += 1


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _wrap_outputs(raw, ctx, out=None, recorded=False):
    multi = isinstance(raw, (tuple, list))
    outs = list(raw) if multi else [raw]
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, r in zip(targets, outs):
            t._set_data(r)
            t._recorded = recorded
        return out
    wrapped = [NDArray(r, ctx=ctx) for r in outs]
    for w in wrapped:
        w._recorded = recorded
        if _engine.is_naive():
            w.wait_to_read()
    return tuple(wrapped) if multi else wrapped[0]


def _invoke(name, inputs, out=None, _named=None, **attrs):
    """The imperative dispatch path: unwrap, run the registered torch
    FCompute eagerly on the inputs' device, wrap. Grad mode is on only
    for a differentiable op while the thread builds a graph."""
    from .. import autograd as _ag

    op = _reg.get(name)
    if op.train_aware and "training" not in attrs:
        attrs["training"] = _ag.is_training()
    graph = op.differentiable and _ag.builds_graph()
    if graph and _ag.is_recording():
        for x in inputs:
            if isinstance(x, NDArray):
                _ag._make_leaf(x)
    ctx = next((x._ctx for x in inputs if isinstance(x, NDArray)), None)
    ctx = ctx or current_context()
    tensors = []
    for x in inputs:
        if isinstance(x, NDArray):
            tensors.append(x._data)
        elif isinstance(x, np.ndarray):
            tensors.append(array(x, ctx=ctx)._data)
        else:
            tensors.append(x)
    if graph == torch.is_grad_enabled():
        raw = _reg.invoke_raw(op, tensors, attrs, tuple(_named or ()))
    else:
        with torch.set_grad_enabled(graph):
            raw = _reg.invoke_raw(op, tensors, attrs, tuple(_named or ()))
    return _wrap_outputs(raw, ctx, out=out, recorded=graph)


def _binary(op_name, scalar_op_name, lhs, rhs):
    if isinstance(rhs, NDArray):
        return _invoke(op_name, [lhs, rhs])
    if isinstance(rhs, numbers.Number):
        return _invoke(scalar_op_name, [lhs], scalar=float(rhs))
    if isinstance(rhs, np.ndarray):
        return _invoke(op_name, [lhs, array(rhs, ctx=lhs.context)])
    return NotImplemented


def _binary_r(op_name, scalar_op_name, lhs, rhs):
    if isinstance(rhs, numbers.Number):
        return _invoke(scalar_op_name, [lhs], scalar=float(rhs))
    if isinstance(rhs, np.ndarray):
        return _invoke(op_name, [array(rhs, ctx=lhs.context), lhs])
    return NotImplemented


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """Create an NDArray from any array-like (reference: mx.nd.array).
    Always copies: mutating the result never touches the source."""
    ctx = ctx if ctx is not None else current_context()
    if isinstance(source_array, NDArray):
        out = source_array.copyto(ctx)
        return out.astype(dtype) if dtype is not None else out
    device = ctx.torch_device
    npv = np.asarray(source_array)
    if dtype is None:
        dtype = mx_real_t if npv.dtype == np.float64 else npv.dtype
    # The host-to-device transfer is itself a copy; only a host target
    # needs one made here.
    host = np.array(npv, dtype=numpy_dtype(dtype), order="C") \
        if device.type == "cpu" else \
        np.ascontiguousarray(npv, dtype=numpy_dtype(dtype))
    t = torch.from_numpy(host).to(device=device, dtype=torch_dtype(dtype))
    return NDArray(t, ctx=ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, numbers.Number):
        shape = (shape,)
    t = torch.full(tuple(shape), val,
                   dtype=torch_dtype(dtype if dtype is not None else mx_real_t),
                   device=ctx.torch_device)
    return NDArray(t, ctx=ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return full(shape, 0, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return full(shape, 1, ctx=ctx, dtype=dtype)


def waitall():
    """Reference: mx.nd.waitall — wait for all work on every card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
