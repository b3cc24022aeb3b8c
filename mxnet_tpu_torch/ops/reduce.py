"""Reductions (``sum``, ``mean``, ``norm``).

Counterpart of the subset of ``mxnet_tpu/ops/reduce.py`` that the served
models use, with MXNet's ``axis``/``keepdims``/``exclude`` attrs.
"""
from __future__ import annotations

import torch

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
        return fn(a, _axes(a, axis, exclude), keepdims)

    register(name)(op)


_reduce("sum", lambda a, ax, kd: torch.sum(a, dim=ax, keepdim=kd))
_reduce("mean", lambda a, ax, kd: torch.mean(a, dim=ax, keepdim=kd))


@register("norm")
def _norm(a, ord=2, axis=None, keepdims=False):
    ax = _axes(a, axis, False)
    if ord == 1:
        return torch.sum(torch.abs(a), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdims))
