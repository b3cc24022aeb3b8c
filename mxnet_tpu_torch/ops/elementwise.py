"""Elementwise binary, scalar and unary operators.

Counterpart of ``mxnet_tpu/ops/elementwise.py``. Broadcast and elemwise
variants share one implementation, as in the JAX package. Scalars keep
the array's dtype (a Python number does not promote a torch tensor).

Two roundings follow the reference (mshadow_op.h) where the JAX package
does not: ``round`` rounds halves away from zero (``jnp.round`` rounds
them to even) and ``rint`` rounds halves down (``jnp.rint``: to even).
``_mod`` is Python's floor modulo (``torch.remainder``), as ``a % b``
is in the JAX package.
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
    ("broadcast_mod", torch.remainder, ("_mod",)),
    ("broadcast_maximum", torch.maximum, ("_maximum", "maximum")),
    ("broadcast_minimum", torch.minimum, ("_minimum", "minimum")),
    ("broadcast_hypot", torch.hypot, ("_hypot",)),
    ("arctan2", torch.atan2, ("_arctan2",)),
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
    "_rpower_scalar": lambda a, scalar=1.0: torch.pow(scalar, a),
    "_mod_scalar": lambda a, scalar=1.0: torch.remainder(a, scalar),
    "_rmod_scalar": lambda a, scalar=1.0: torch.remainder(
        a.new_tensor(scalar), a),
    "_maximum_scalar": lambda a, scalar=0.0: torch.maximum(
        a, a.new_tensor(scalar)),
    "_minimum_scalar": lambda a, scalar=0.0: torch.minimum(
        a, a.new_tensor(scalar)),
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


def _register_logical(name, fn):
    register("broadcast_" + name, differentiable=False, aliases=("_" + name,))(
        lambda a, b: fn(a != 0, b != 0).to(a.dtype))


for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    _register_logical(_name, _fn)

register("identity", aliases=("_copy", "identity_with_attr_like_rhs"))(
    lambda a: a)

_UNARY = {
    "negative": torch.neg,
    "relu": torch.relu,
    "abs": torch.abs,
    "square": lambda a: a * a,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "sign": torch.sign,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "reciprocal": lambda a: 1.0 / a,
    "rsqrt": lambda a: 1.0 / torch.sqrt(a),
    "cbrt": lambda a: _cbrt(a),
    "rcbrt": lambda a: 1.0 / _cbrt(a),
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "gamma": lambda a: torch.exp(torch.lgamma(a)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "softsign": lambda a: a / (1 + torch.abs(a)),
}
for _name, _fn in _UNARY.items():
    register(_name)(_fn)


def _cbrt(a):
    """The real cube root, odd in `a` (torch has no cbrt)."""
    return torch.sign(a) * torch.pow(torch.abs(a), 1.0 / 3.0)


def _round_half_away(a):
    """C's round(): halves go away from zero. ``a - trunc(a)`` is exact,
    so no half is lost to rounding, as ``floor(|a| + 0.5)`` loses
    0.49999997 in float32."""
    t = torch.trunc(a)
    return torch.where(torch.abs(a - t) >= 0.5, t + torch.sign(a), t)


def _rint_half_down(a):
    """mshadow_op.h's rint: the nearer of floor and ceil, floor on a
    tie."""
    lo, hi = torch.floor(a), torch.ceil(a)
    return torch.where(a - lo <= hi - a, lo, hi)


# Rounding, tests and logical_not: no gradient.
_NO_GRAD_UNARY = {
    "round": _round_half_away,
    "rint": _rint_half_down,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "logical_not": lambda a: (a == 0).to(a.dtype),
    "isnan": lambda a: torch.isnan(a).to(torch.float32),
    "isinf": lambda a: torch.isinf(a).to(torch.float32),
}
for _name, _fn in _NO_GRAD_UNARY.items():
    register(_name, differentiable=False)(_fn)


@register("cast", aliases=("Cast",))
def _cast(a, dtype="float32"):
    return a.to(torch_dtype(dtype))


@register("clip")
def _clip(a, a_min=None, a_max=None):
    return torch.clamp(a, a_min, a_max)


@register("where")
def _where(cond, x, y):
    """x where `cond` is non-zero, else y; `cond` gets no gradient."""
    return torch.where(cond != 0, x, y)


@register("smooth_l1")
def _smooth_l1(a, scalar=1.0):
    s2 = scalar * scalar
    absa = torch.abs(a)
    return torch.where(absa < 1.0 / s2, 0.5 * s2 * a * a, absa - 0.5 / s2)


@register("_scatter_set_nd", differentiable=False)
def _scatter_set_nd(data, indices, value):
    """`data` with the entries at `indices` (one row per axis) set to
    `value`."""
    idx = tuple(indices.to(torch.int64))
    return data.index_put(idx, torch.as_tensor(value, dtype=data.dtype,
                                               device=data.device))


@register("stop_gradient", aliases=("BlockGrad", "make_loss_grad_block"))
def _stop_gradient(a):
    """The value, with a zero gradient to `a`."""
    return a.detach()
