"""Shape-manipulation, indexing and creation operators, ``dot`` and
``batch_dot``.

Counterpart of ``mxnet_tpu/ops/matrix.py``, with MXNet's reshape special
codes. Index outputs (``ravel_multi_index``, ``unravel_index``) are
float32 and ``shape_array``/``size_array`` int64, as in the JAX package.
Indices read from a tensor are clipped into range before they index, so
that an index out of range never reaches the card as a device-side
assert. The creation ops (``zeros``, ``arange``, ...) take ``device``
from dispatch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
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


# -- the rest of mxnet_tpu/ops/matrix.py --------------------------------------

@register("reshape_like")
def _reshape_like(a, b):
    return a.reshape(b.shape)


@register("shape_array", differentiable=False)
def _shape_array(a):
    return torch.tensor(a.shape, dtype=torch.int64, device=a.device)


@register("size_array", differentiable=False)
def _size_array(a):
    return torch.tensor([a.numel()], dtype=torch.int64, device=a.device)


@register("squeeze")
def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for d in sorted((x % a.ndim for x in axes), reverse=True):
        if a.shape[d] != 1:
            raise ValueError("squeeze: axis %d has size %d" % (d, a.shape[d]))
        a = a.squeeze(d)
    return a


@register("broadcast_to")
def _broadcast_to(a, shape=()):
    """0 in `shape` keeps that axis of `a` (when the ranks agree)."""
    target = tuple(d if s == 0 else s for s, d in zip(shape, a.shape)) \
        if len(shape) == a.ndim else tuple(shape)
    return a.expand(*target)


@register("broadcast_like")
def _broadcast_like(a, b):
    return a.expand(*b.shape)


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(a, dim1=0, dim2=0):
    return torch.swapaxes(a, dim1, dim2)


@register("moveaxis")
def _moveaxis(a, source=0, destination=0):
    return torch.movedim(a, source, destination)


@register("flip", aliases=("reverse",))
def _flip(a, axis=0):
    return torch.flip(a, (axis,) if isinstance(axis, int) else tuple(axis))


def _strided(a, axis, begin, end, step):
    """a[begin:end:step] along `axis`, any sign of step (torch slices
    take positive steps only)."""
    n = a.shape[axis]
    start, stop, step = slice(begin, end, step).indices(n)
    if step > 0:
        return a.narrow(axis, start, max(stop - start, 0)) \
            if step == 1 else a[(slice(None),) * axis
                                + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=a.device)
    return torch.index_select(a, axis, idx)


@register("slice", aliases=("crop",))
def _slice(a, begin=(), end=(), step=()):
    """a[b0:e0:s0, b1:e1:s1, ...]; None entries take the defaults."""
    for i in range(len(begin)):
        st = step[i] if step and i < len(step) and step[i] is not None \
            else 1
        a = _strided(a, i, begin[i], end[i], st)
    return a


@register("slice_like")
def _slice_like(a, b, axes=()):
    for ax in (axes if axes else range(min(a.ndim, b.ndim))):
        a = a.narrow(ax, 0, b.shape[ax])
    return a


@register("_index")
def _index(a, key=None):
    """a[key]; `key` may be the JAX package's hashable wrapper."""
    return a[getattr(key, "key", key)]


@register("batch_take")
def _batch_take(a, indices):
    idx = torch.clamp(indices.to(torch.int64), 0, a.shape[1] - 1)
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _index_rows(indices, shape):
    """The rows of an (k, ...) index tensor as a tuple of int64 index
    tensors, negative entries wrapped and every entry clipped into its
    axis of `shape`."""
    idx = indices.to(torch.int64)
    rows = []
    for i in range(idx.shape[0]):
        n = shape[i]
        r = torch.where(idx[i] < 0, idx[i] + n, idx[i])
        rows.append(torch.clamp(r, 0, n - 1))
    return tuple(rows)


@register("gather_nd")
def _gather_nd(a, indices):
    return a[_index_rows(indices, a.shape)]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_index_rows(indices, shape), data)


@register("_scatter_nd_add")
def _scatter_nd_add(data, indices, shape=()):
    """As scatter_nd, with repeated indices summed (index_put's
    accumulate, which sorts on the card: deterministic)."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_index_rows(indices, shape), data, accumulate=True)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of `depth` classes; an index out of [0, depth) gives a row of
    `off_value`, as jax.nn.one_hot does."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    classes = torch.arange(depth, device=indices.device)
    oh = (idx == classes).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("tile")
def _tile(a, reps=()):
    return torch.tile(a, tuple(reps))


@register("repeat")
def _repeat(a, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _pad_index(n, before, after, mode, device):
    """Source positions along one axis of a padded copy: ``edge``
    repeats the border, ``reflect`` mirrors about it (numpy's modes)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register("pad", aliases=("Pad",))
def _pad(a, mode="constant", pad_width=(), constant_value=0.0):
    """numpy's pad with (before, after) pairs flat in `pad_width`, one
    pair per axis from the first."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for before, after in reversed(pairs):
            flat += [before, after]
        return F.pad(a, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %s" % mode)
    for axis, (before, after) in enumerate(pairs):
        if before or after:
            a = torch.index_select(a, axis, _pad_index(
                a.shape[axis], before, after, mode, a.device))
    return a


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


@register("diag")
def _diag(a, k=0):
    if a.ndim == 1:
        return torch.diag(a, k)
    return torch.diagonal(a, offset=k, dim1=-2, dim2=-1)


@register("depth_to_space")
def _depth_to_space(a, block_size=1):
    n, c, h, w = a.shape
    bs = block_size
    x = a.reshape(n, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def _space_to_depth(a, block_size=1):
    n, c, h, w = a.shape
    bs = block_size
    x = a.reshape(n, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(indices, shape=()):
    strides = torch.tensor([math.prod(shape[i + 1:])
                            for i in range(len(shape))],
                           dtype=torch.int64, device=indices.device)
    flat = (indices.to(torch.int64) * strides[:, None]).sum(0)
    return flat.to(torch.float32)


@register("unravel_index", differentiable=False)
def _unravel_index(indices, shape=()):
    """(len(shape), ...) float32 coordinates of flat indices, clipped
    into [0, prod(shape)) as jnp.unravel_index clips them."""
    idx = torch.clamp(indices.to(torch.int64), 0, math.prod(shape) - 1)
    coords = []
    for n in reversed(shape):
        coords.append(torch.remainder(idx, n))
        idx = torch.div(idx, n, rounding_mode="floor")
    return torch.stack(coords[::-1]).to(torch.float32)


@register("zeros", aliases=("_zeros",), differentiable=False, creates=True)
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("ones", aliases=("_ones",), differentiable=False, creates=True)
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("full", aliases=("_full",), differentiable=False, creates=True)
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("arange", aliases=("_arange",), differentiable=False, creates=True)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    """numpy's arange on `device`: ceil((stop - start) / step) values
    start + i * step, each computed in float64 and rounded once to
    `dtype`, each repeated `repeat` times."""
    if stop is None:
        start, stop = 0, start
    n = max(int(math.ceil((stop - start) / step)), 0)
    i = torch.arange(n, dtype=torch.float64, device=device)
    out = (i * step + start).to(torch_dtype(dtype))
    return torch.repeat_interleave(out, repeat) if repeat != 1 else out
