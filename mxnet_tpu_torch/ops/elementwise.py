"""Elementwise binary, scalar and unary operators.

Counterpart of the subset of ``mxnet_tpu/ops/elementwise.py`` that the
served models and the losses use. Broadcast and elemwise variants share one
implementation, as in the JAX package. Scalars keep the array's dtype
(a Python number does not promote a torch tensor).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

_BINARY = [
    ("broadcast_add", torch.add, ("elemwise_add", "broadcast_plus", "_add", "_plus")),
    ("broadcast_sub", torch.sub, ("elemwise_sub", "broadcast_minus", "_sub", "_minus")),
    ("broadcast_mul", torch.mul, ("elemwise_mul", "_mul")),
    ("broadcast_div", torch.div, ("elemwise_div", "_div")),
]
for _name, _fn, _aliases in _BINARY:
    register(_name, aliases=_aliases)(_fn)

_SCALAR = {
    "_plus_scalar": lambda a, scalar=0.0: a + scalar,
    "_minus_scalar": lambda a, scalar=0.0: a - scalar,
    "_rminus_scalar": lambda a, scalar=0.0: scalar - a,
    "_mul_scalar": lambda a, scalar=1.0: a * scalar,
    "_div_scalar": lambda a, scalar=1.0: a / scalar,
    "_rdiv_scalar": lambda a, scalar=1.0: scalar / a,
}
for _name, _fn in _SCALAR.items():
    register(_name)(_fn)

_UNARY = {
    "identity": lambda a: a,
    "negative": torch.neg,
    "relu": torch.relu,
    "abs": torch.abs,
    "square": lambda a: a * a,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
}
for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("cast", aliases=("Cast",))
def _cast(a, dtype="float32"):
    return a.to(torch_dtype(dtype))
