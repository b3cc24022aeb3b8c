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

# Each binary FCompute takes (a, b), as in the JAX package, so a symbol
# composed from either package names its inputs alike.
_BINARY = [
    ("broadcast_add", lambda a, b: a + b,
     ("elemwise_add", "broadcast_plus", "_add", "_plus")),
    ("broadcast_sub", lambda a, b: a - b,
     ("elemwise_sub", "broadcast_minus", "_sub", "_minus")),
    ("broadcast_mul", lambda a, b: a * b, ("elemwise_mul", "_mul")),
    ("broadcast_div", lambda a, b: a / b, ("elemwise_div", "_div")),
    ("broadcast_power", lambda a, b: a ** b, ("_power", "pow")),
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
    "_power_scalar": lambda a, scalar=1.0: a ** scalar,
}
for _name, _fn in _SCALAR.items():
    register(_name)(_fn)

# Comparisons return 0/1 in the input's dtype and have no gradient (the
# symbol operators <, <=, >, >= compose them).
_COMPARE = {"greater": torch.gt, "greater_equal": torch.ge,
            "lesser": torch.lt, "lesser_equal": torch.le,
            "equal": torch.eq, "not_equal": torch.ne}


def _register_compare(name, cmp):
    register("broadcast_" + name, differentiable=False,
             aliases=("_" + name,))(lambda a, b: cmp(a, b).to(a.dtype))
    register("_%s_scalar" % name, differentiable=False)(
        lambda a, scalar=0.0: cmp(a, scalar).to(a.dtype))


for _name, _fn in _COMPARE.items():
    _register_compare(_name, _fn)

_UNARY = {
    "identity": lambda a: a,
    "negative": torch.neg,
    "relu": torch.relu,
    "abs": torch.abs,
    "square": lambda a: a * a,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "sign": torch.sign,
}
for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("cast", aliases=("Cast",))
def _cast(a, dtype="float32"):
    return a.to(torch_dtype(dtype))


@register("clip")
def _clip(a, a_min=None, a_max=None):
    return torch.clamp(a, a_min, a_max)
