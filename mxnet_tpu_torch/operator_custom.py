"""mx.operator — user-defined operators with Python callbacks.

Counterpart of ``mxnet_tpu/operator_custom.py`` (reference:
python/mxnet/operator.py, CustomOp/CustomOpProp + register, over
src/operator/custom/custom-inl.h:50-170, whose callbacks run on a thread
pool off the engine threads). A registered custom op becomes
``mx.nd.Custom(...)`` / ``mx.sym.Custom(...)``.

One path, eager: the port has no traced graph (its CachedOp counts
signatures, its Executor interprets the DAG), so the user's ``forward``
and ``backward`` run inline wherever the op runs: imperatively, inside
a hybridized block, and in a bound Executor or Module. The gradient is
a ``torch.autograd.Function`` (``autograd._Bridge``), so
``autograd.backward`` and ``Executor.backward`` both reach the user's
``backward``. ``req`` is ``"write"``, ``aux`` is empty and the operator
instance is created once per call, as in the JAX package's eager path.

The callbacks get NDArrays on the op's device and ``create_operator``
the real ``Context``: an op written in NDArray arithmetic makes no host
copy on a card. (The JAX package's traced path hands the callbacks host
copies and ``ctx=None``.)

Shape inference never runs the user's ``forward``: ``Symbol.infer_shape``
takes a Custom node's output shapes from ``CustomOpProp.infer_shape``
(the registry entry's ``infer_shape``), as the JAX package's
``ShapeDtypeStruct``\\ s do.
"""
from __future__ import annotations

import numpy as np

from .base import dtype_name
from .context import Context
from .ndarray.ndarray import zeros as nd_zeros
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators", "Custom"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for the runtime op (reference operator.py:CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Write `src` into `dst` honoring the gradient request
        (reference operator.py:CustomOp.assign)."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """Describes a custom op (reference operator.py:CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under `reg_name`
    (reference operator.py:register)."""

    def deco(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators():
    return sorted(_CUSTOM_REGISTRY)


def _make_prop(op_type, attrs):
    if op_type not in _CUSTOM_REGISTRY:
        raise ValueError(
            "custom op %r is not registered (known: %s)"
            % (op_type, get_all_registered_operators()))
    # The reference passes ctor kwargs as strings; we pass them through.
    return _CUSTOM_REGISTRY[op_type](**attrs)


def _np_dtype(t):
    return np.dtype(dtype_name(t.dtype))


class _CustomFunction:
    """The user's operator as an ``autograd.Function`` body: NDArrays in,
    NDArrays out; ``autograd._Bridge`` carries it through torch's graph
    with recording paused."""

    def __init__(self, op, is_train, out_specs, in_specs):
        self._op = op
        self._is_train = is_train
        self._out_specs = out_specs      # (shape, dtype, ctx) per output
        self._in_specs = in_specs        # (shape, dtype, ctx) per input

    def forward(self, *ins):
        out_data = [nd_zeros(s, ctx=c, dtype=t)
                    for s, t, c in self._out_specs]
        self._op.forward(is_train=self._is_train,
                         req=["write"] * len(out_data), in_data=list(ins),
                         out_data=out_data, aux=[])
        self._in_data, self._out_data = list(ins), out_data
        return out_data[0] if len(out_data) == 1 else tuple(out_data)

    def backward(self, *ograds):
        in_grad = [nd_zeros(s, ctx=c, dtype=t)
                   for s, t, c in self._in_specs]
        self._op.backward(req=["write"] * len(in_grad),
                          out_grad=list(ograds), in_data=self._in_data,
                          out_data=self._out_data, in_grad=in_grad, aux=[])
        return tuple(g._data for g in in_grad)


def _prop_of(attrs):
    clean = {k: v for k, v in attrs.items()
             if k not in ("_op_name", "op_type", "training")
             and not (k.startswith("__") and k.endswith("__"))}
    return _make_prop(attrs["op_type"], clean)


def _custom_num_outputs(attrs):
    return len(_prop_of(attrs).list_outputs())


def _custom_shapes(attrs, in_shapes):
    """(input shapes, output shapes) from ``CustomOpProp.infer_shape``;
    an input shape not known yet goes in as None, and what the prop
    gives back for it is taken."""
    got_in, got_out, _ = _prop_of(attrs).infer_shape(
        [list(s) if s is not None else None for s in in_shapes])
    return ([tuple(s) if s is not None else None for s in got_in],
            [tuple(s) for s in got_out])


@_register_op("Custom", num_inputs=None, train_aware=True,
              infer_shape=_custom_shapes)
def _custom(*tensors, op_type=None, training=False, **attrs):
    """FCompute of `Custom`: the user's forward on NDArrays on the
    inputs' devices; under a recording graph its backward is the
    gradient (reference custom-inl.h:116, the callbacks pushed inline)."""
    from . import autograd

    prop = _make_prop(op_type, attrs)
    in_shapes = [list(t.shape) for t in tensors]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [_np_dtype(t) for t in tensors]
    _, out_types, _ = prop.infer_type(in_types)
    contexts = [Context.of(t.device) for t in tensors]
    ctx = contexts[0]
    op = prop.create_operator(ctx, in_shapes, in_types)
    func = _CustomFunction(
        op, bool(training),
        [(tuple(s), t, ctx) for s, t in zip(out_shapes, out_types)],
        [(tuple(s), t, c) for s, t, c in zip(in_shapes, in_types,
                                             contexts)])
    outs = autograd._Bridge.apply(func, contexts, *tensors)
    return outs[0] if len(outs) == 1 else tuple(outs)


def Custom(*inputs, op_type=None, out=None, **attrs):
    """``mx.nd.Custom``: the callbacks run inline, recorded for
    ``backward()`` under ``autograd.record()``."""
    from .ndarray.ndarray import _invoke

    return _invoke("Custom", list(inputs), out=out, op_type=op_type,
                   **attrs)


# Symbol composition needs the output count before execution
# (reference: CustomOpProp.list_outputs feeds NNVM's num_outputs).
from . import symbol as _symbol  # noqa: E402

_symbol._NUM_OUTPUT_RULES["Custom"] = _custom_num_outputs

# mx.nd.Custom is the eager entry above.
from .ndarray import _FUNC_CACHE as _ND_FUNC_CACHE  # noqa: E402

_ND_FUNC_CACHE["Custom"] = Custom
