"""`mx.nd` — the imperative array API of the port.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: module ``__getattr__``
resolves any registered operator name to a dispatch function, so
``nd.<op>`` exists for every op in ``mxnet_tpu_torch.ops``.
"""
from __future__ import annotations

import inspect

from .. import ops as _ops  # noqa: F401  (registers every operator)
from ..ops import registry as _registry
from .ndarray import NDArray, array, zeros, ones, full, waitall, _invoke
from .utils import save, load, save_dict, load_dict
from . import contrib  # noqa: F401

__all__ = ["NDArray", "array", "zeros", "ones", "full", "waitall", "save",
           "load", "save_dict", "load_dict"]

_FUNC_CACHE = {}


def _make_op_func(name):
    op = _registry.get(name)
    try:
        params = list(inspect.signature(op.fn).parameters)
    except (TypeError, ValueError):
        params = []

    def op_func(*args, out=None, **kwargs):
        inputs, attrs, named = [], {}, []
        for i, a in enumerate(args):
            if isinstance(a, NDArray) or hasattr(a, "shape") or a is None:
                inputs.append(a)
            elif i < len(params):
                # Positional scalar: bind to the op parameter at this
                # position (reference: attrs parsed from kwargs strings).
                attrs[params[i]] = a
            else:
                inputs.append(a)
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                named.append(k)
                inputs.append(v)
            else:
                attrs[k] = v
        return _invoke(name, inputs, out=out, _named=named, **attrs)

    op_func.__name__ = name
    op_func.__doc__ = "Registered operator %r (%s)" % (
        name, getattr(op.fn, "__module__", "?"))
    return op_func


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        return _FUNC_CACHE[name]
    except KeyError:
        pass
    _registry.get(name)  # raises AttributeError if unknown
    fn = _FUNC_CACHE[name] = _make_op_func(name)
    globals()[name] = fn
    return fn
