"""The collectives of the port's data and sequence parallelism.

The JAX package gets its collectives from GSPMD (a ``psum`` that XLA
inserts) and ``shard_map`` (``all_gather``, ``ppermute``). The port
calls ``torch.distributed`` on an explicit group, and only through the
operations every backend takes: ``all_reduce``, ``broadcast`` and
``all_gather`` (NCCL, and gloo on host and CUDA tensors alike) and
point-to-point ``batch_isend_irecv``.

- :func:`all_reduce` is differentiable: its gradient is the all-reduce
  of the incoming gradients, the adjoint of a sum every rank reads.
- :func:`gather_slots` is an all-gather written as an all-reduce over a
  zero-filled ``(n, ...)`` buffer in which each rank fills its own slot:
  adding zeros is exact, so slot ``i`` holds rank ``i``'s value (a
  -0.0 comes back as +0.0, equal in value).
- :func:`all_reduce_flat` sums many tensors in one call per dtype,
  through one flat buffer (the copies in and out are exact);
  :func:`broadcast_flat` gives every rank of a group one rank's tensors
  the same way.
- :func:`gather` rebuilds the full values of tensors placed by a
  ``NamedSharding`` (``mesh.place``), differentiably: the forward is an
  ``all_gather`` over each axis group a dimension is split over (NCCL
  and gloo take it, gloo on CUDA tensors too), one call per axis, dtype
  and round for all the tensors; the backward is this rank's block of
  the incoming gradient. That block is the gradient exactly where the
  ranks of the axis group see the same rows: every axis but the batch
  axis ``dp`` (the batch is split over ``dp`` only), so a ``tp`` group
  computes one replicated loss. Over ``dp`` the adjoint also sums the
  gradient over the group first (a reduce-scatter), as each of its
  ranks differentiates its own rows.
- :func:`sq_sum` is the sum of squares of a tensor's blocks over the
  axis groups it is split over (a norm of a sharded weight).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

__all__ = ["all_reduce", "all_reduce_flat", "broadcast_flat",
           "gather_slots", "group_size", "gather", "sq_sum"]

# The axes a global batch is split over: the one place that names them
# (mesh.data_sharding, Mesh.local_slice, the gather's backward and the
# TrainStep's replica broadcast read it).
BATCH_AXES = ("dp",)


def group_size(group):
    return tdist.get_world_size(group=group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce(t, group):
    """The sum of `t` over `group`, differentiable."""
    return _AllReduce.apply(t, group)


def _flat_call(tensors, call):
    """`call(flat)` in place on one flat buffer per dtype of `tensors`;
    returns new tensors of the same shapes."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        call(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def all_reduce_flat(tensors, group):
    """Sum each tensor of `tensors` over `group`; returns new tensors of
    the same shapes, one all_reduce per dtype."""
    return _flat_call(tensors, lambda flat: tdist.all_reduce(flat,
                                                             group=group))


def broadcast_flat(tensors, src, group):
    """Rank `src`'s `tensors` (a global rank of `group`) on every rank
    of `group`; returns new tensors of the same shapes, one broadcast
    per dtype."""
    return _flat_call(tensors, lambda flat: tdist.broadcast(
        flat, src=src, group=group))


def gather_slots(t, group):
    """(n, *t.shape): slot ``i`` is rank ``i``'s `t` (the rank's index
    in `group`), on every rank of `group`."""
    n = tdist.get_world_size(group=group)
    buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[tdist.get_rank(group=group)] = t
    tdist.all_reduce(buf, group=group)
    return buf


def _gather_steps(sharding, ndim):
    """[(dim, axis), ...]: the all-gathers that rebuild a block, minor
    axis of an entry first."""
    from .mesh import spec_axes

    steps = []
    for d in range(ndim):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        steps.extend((d, ax) for ax in reversed(spec_axes(entry)))
    return steps


def _gather_forward(shards, shardings):
    cur = list(shards)
    steps = [_gather_steps(s, t.dim()) for t, s in zip(cur, shardings)]
    for j in range(max((len(s) for s in steps), default=0)):
        rounds = {}
        for i, st in enumerate(steps):
            if j < len(st):
                ax = st[j][1]
                key = (ax, cur[i].dtype)
                rounds.setdefault(key, []).append(i)
        for (ax, _), idx in rounds.items():
            group = shardings[idx[0]].mesh.group(ax)
            flat = torch.cat([cur[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat)
                     for _ in range(tdist.get_world_size(group=group))]
            tdist.all_gather(parts, flat, group=group)
            off = 0
            for i in idx:
                n, shape, d = cur[i].numel(), cur[i].shape, steps[i][j][0]
                cur[i] = torch.cat([p[off:off + n].view(shape)
                                    for p in parts], dim=d)
                off += n
    return cur


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shardings, *shards):
        ctx.shardings = shardings
        ctx.shapes = [tuple(t.shape) for t in shards]
        return tuple(_gather_forward(shards, shardings))

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, s, shape in zip(grads, ctx.shardings, ctx.shapes):
            if g is None:
                out.append(None)
                continue
            for ax in s.axes:
                if ax in BATCH_AXES:
                    g = g.clone(memory_format=torch.contiguous_format)
                    tdist.all_reduce(g, group=s.mesh.group(ax))
            sl = tuple(slice(a, b) for a, b in s.bounds(g.shape))
            out.append(g[sl])
        return (None,) + tuple(out)


def gather(shards, shardings):
    """The full values of `shards` (this rank's blocks, ``mesh.place``)
    under `shardings` (``NamedSharding`` over a mesh of ranks), as a
    list; differentiable. A sharding without axes, or on a one-device
    mesh, passes its tensor through. Every rank of the mesh calls it
    with the same shardings in the same order."""
    out = list(shards)
    idx = [i for i, s in enumerate(shardings)
           if getattr(s, "axes", ()) and s.mesh.over_ranks]
    if idx:
        got = _Gather.apply([shardings[i] for i in idx],
                            *[shards[i] for i in idx])
        for i, t in zip(idx, got):
            out[i] = t
    return out


def sq_sum(t, sharding):
    """The sum of the squares of the full array whose block `t` this
    rank holds under `sharding` (a 0-d tensor, the same on the ranks
    that share the array)."""
    acc = (t * t).sum()
    if getattr(sharding, "axes", ()) and sharding.mesh.over_ranks:
        for ax in dict.fromkeys(sharding.axes):
            tdist.all_reduce(acc, group=sharding.mesh.group(ax))
    return acc
