"""Shape-manipulation operators, ``dot``, ``pick`` and ``take``.

Counterpart of the subset of ``mxnet_tpu/ops/matrix.py`` that the
served models, the losses and the recurrent cells use, with MXNet's
reshape special codes.
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


# -- the shape ops the recurrent cells compose (mxnet_tpu/ops/matrix.py
# :106-352) -----------------------------------------------------------------

@register("expand_dims")
def _expand_dims(a, axis=0):
    return a.unsqueeze(axis)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(a, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    target = list(a.shape)
    for ax, s in zip(axis, size):
        target[ax] = s
    return a.expand(*target)


@register("concat", aliases=("Concat",))
def _concat(*arrays, dim=1, num_args=None):
    return torch.cat(arrays, dim=dim)


@register("stack")
def _stack(*arrays, axis=0, num_args=None):
    return torch.stack(arrays, dim=axis)


@register("split", aliases=("SliceChannel", "slice_channel"))
def _split(a, num_outputs=1, axis=1, squeeze_axis=False):
    """`num_outputs` equal parts along `axis`; one part comes back as an
    array, several as a tuple (the JAX op's convention)."""
    n = int(num_outputs)
    if a.shape[axis] % n:
        raise ValueError("split: axis %d of size %d does not divide into %d"
                         % (axis, a.shape[axis], n))
    outs = torch.chunk(a, n, dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs) if n > 1 else outs[0]


@register("slice_axis")
def _slice_axis(a, axis=0, begin=0, end=None):
    return a.narrow(axis, *_span(a.shape[axis], begin, end))


def _span(n, begin, end):
    """(start, length) of Python's slice(begin, end) over n items."""
    start, stop, _ = slice(begin, end).indices(n)
    return start, max(stop - start, 0)


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    """Rows of `a` along `axis` at `indices`, clipped into range (or
    wrapped with ``mode="wrap"``): an index out of range never reaches
    the device as such."""
    idx = indices.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, a.shape[axis])
    else:
        idx = torch.clamp(idx, 0, a.shape[axis] - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    axis = axis % a.ndim
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("zeros_like")
def _zeros_like(a):
    return torch.zeros_like(a)


@register("ones_like")
def _ones_like(a):
    return torch.ones_like(a)
