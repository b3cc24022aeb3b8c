"""Shape-manipulation operators, ``dot`` and ``pick``.

Counterpart of the subset of ``mxnet_tpu/ops/matrix.py`` that the
served models and the losses use, with MXNet's reshape special codes.
"""
from __future__ import annotations

import torch

from .registry import register


def _solve_reshape_spec(src, spec):
    """Expand MXNet reshape special codes (matrix_op-inl.h): 0 copy dim,
    -1 infer, -2 copy rest, -3 merge two dims, -4 split one dim."""
    out = []
    i = 0  # index into src
    j = 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        elif s == -1:
            out.append(-1)
            i += 1
        else:
            out.append(s)
            i += 1
        j += 1
    return out


@register("reshape", aliases=("Reshape",))
def _reshape(a, shape=(), reverse=False):
    if reverse:
        spec = list(reversed(list(shape)))
        # keep each (-4, d1, d2) triple in its internal order
        k = 0
        while k + 2 < len(spec):
            if spec[k + 2] == -4:
                spec[k], spec[k + 1], spec[k + 2] = -4, spec[k], spec[k + 1]
                k += 3
            else:
                k += 1
        solved = _solve_reshape_spec(list(reversed(a.shape)), spec)
        return a.reshape(tuple(reversed(solved)))
    return a.reshape(tuple(_solve_reshape_spec(list(a.shape), list(shape))))


@register("transpose")
def _transpose(a, axes=None):
    return a.permute(*axes) if axes else a.permute(*reversed(range(a.ndim)))


@register("flatten", aliases=("Flatten",))
def _flatten(a):
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    return torch.matmul(a, b)


@register("pick")
def _pick(a, index, axis=-1, keepdims=False, mode="clip"):
    """a's entries at `index` along `axis`; indices are clipped into
    range (the reference's default ``mode="clip"``)."""
    axis = axis % a.ndim
    idx = torch.clamp(index.to(torch.int64), 0, a.shape[axis] - 1)
    out = torch.take_along_dim(a, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)
