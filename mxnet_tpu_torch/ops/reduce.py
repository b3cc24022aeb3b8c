"""Reductions and ordering operators.

Counterpart of ``mxnet_tpu/ops/reduce.py``, with MXNet's
``axis``/``keepdims``/``exclude`` attrs. Index outputs (``argmax``,
``argsort``, ``topk``'s indices) are float32, as in the JAX package.

Orderings use the stable sort on every device: ties keep their input
order, as XLA's sort keeps them, so the indices of tied values match
the JAX package's too. A descending order is the ascending one flipped,
as there (ties then come last index first).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _axes(a, axis, exclude):
    if axis is None:
        return tuple(range(a.ndim))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(x % a.ndim for x in ax)
    if exclude:
        ax = tuple(i for i in range(a.ndim) if i not in ax)
    return ax


def _reduce(name, fn):
    def op(a, axis=None, keepdims=False, exclude=False):
        ax = _axes(a, axis, exclude)
        if not ax and a.ndim:
            # No axis left (``exclude`` of every axis of a 1-D array):
            # numpy's reduction over no axis, where torch's empty `dim`
            # would reduce over all of them.
            return fn(a.unsqueeze(0), (0,), False)
        return fn(a, ax, keepdims)

    register(name)(op)


def _prod(a, ax, kd):
    """torch.prod over several axes, one axis at a time."""
    for d in sorted(ax, reverse=True):
        a = torch.prod(a, dim=d, keepdim=True)
    return a if kd else a.reshape([n for i, n in enumerate(a.shape)
                                   if i not in ax])


_reduce("sum", lambda a, ax, kd: torch.sum(a, dim=ax, keepdim=kd))
_reduce("mean", lambda a, ax, kd: torch.mean(a, dim=ax, keepdim=kd))
_reduce("max", lambda a, ax, kd: torch.amax(a, dim=ax, keepdim=kd))
_reduce("min", lambda a, ax, kd: torch.amin(a, dim=ax, keepdim=kd))
_reduce("prod", _prod)
_reduce("nansum", lambda a, ax, kd: torch.nansum(a, dim=ax, keepdim=kd))
_reduce("nanprod", lambda a, ax, kd: _prod(
    torch.where(torch.isnan(a), torch.ones_like(a), a), ax, kd))


@register("norm")
def _norm(a, ord=2, axis=None, keepdims=False):
    ax = _axes(a, axis, False)
    if ord == 1:
        return torch.sum(torch.abs(a), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdims))


@register("sum_axis", aliases=("sum_mid_internal",))
def _sum_axis(a, axis=None, keepdims=False):
    return torch.sum(a, dim=_axes(a, axis, False), keepdim=keepdims)


def _arg(fn):
    def op(a, axis=None, keepdims=False):
        if axis is None:
            return fn(a.reshape(-1), 0).to(torch.float32)
        out = fn(a, axis % a.ndim)
        if keepdims:
            out = out.unsqueeze(axis)
        return out.to(torch.float32)

    return op


register("argmax", differentiable=False)(
    _arg(lambda a, d: torch.argmax(a, dim=d)))
register("argmin", differentiable=False)(
    _arg(lambda a, d: torch.argmin(a, dim=d)))


@register("argmax_channel", differentiable=False)
def _argmax_channel(a):
    return torch.argmax(a, dim=1).to(torch.float32)


@register("sort")
def _sort(a, axis=-1, is_ascend=True):
    out = torch.sort(a, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def _argsort(a, axis=-1, is_ascend=True):
    idx = torch.sort(a, dim=axis, stable=True).indices
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch.float32)


@register("topk", differentiable=False)
def _topk(a, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    """The first `k` of the stable order of ``a`` (ascending) or ``-a``
    along `axis`: values, float32 indices, both, or a 0/1 mask of
    them in `a`'s dtype."""
    if ret_typ not in ("indices", "value", "both", "mask"):
        raise ValueError("unknown ret_typ %s" % ret_typ)
    ax = (axis if axis is not None else -1) % a.ndim
    key = a if is_ascend else -a
    idx = torch.sort(key, dim=ax, stable=True).indices.narrow(ax, 0, k)
    if ret_typ == "mask":
        return torch.zeros_like(a).scatter_(ax, idx, 1)
    vals = torch.take_along_dim(a, idx, dim=ax)
    idx = idx.to(torch.float32)
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx


@register("cumsum")
def _cumsum(a, axis=None, dtype=None):
    out = torch.cumsum(a.reshape(-1) if axis is None else a,
                       dim=0 if axis is None else axis)
    return out.to(torch_dtype(dtype)) if dtype is not None else out


@register("histogram", differentiable=False)
def _histogram(a, bin_cnt=10, range=None):
    """(counts, edges), both float32: `bin_cnt` equal bins over `range`
    (default (0, 1)), the last closed on the right, values outside
    dropped, as ``jnp.histogram`` bins them (searchsorted on the
    edges). The edges are lo (1 - t) + hi t with t = i / bin_cnt, as
    jnp.linspace forms them, each operation rounded on its own so that
    every device gives the same edges (XLA's fused ones may differ from
    them in the last bit). t is divided in float64 and rounded once,
    which the card and the host round alike; a float32 division by a
    scalar gave other edges on the card than on the host."""
    lo, hi = range if range is not None else (0.0, 1.0)
    t = (torch.arange(bin_cnt, dtype=torch.float64, device=a.device)
         / bin_cnt).to(a.dtype)
    edges = torch.cat([float(lo) * (1 - t) + float(hi) * t,
                       torch.full((1,), float(hi), dtype=a.dtype,
                                  device=a.device)])
    flat = a.reshape(-1)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bin_cnt, idx)
    counts = torch.bincount(idx, minlength=bin_cnt + 2)[1:bin_cnt + 1]
    return counts.to(torch.float32), edges.to(torch.float32)
