"""The collectives of the port's data and sequence parallelism.

The JAX package gets its collectives from GSPMD (a ``psum`` that XLA
inserts) and ``shard_map`` (``all_gather``, ``ppermute``). The port
calls ``torch.distributed`` on an explicit group, and only through the
operations every backend takes: ``all_reduce`` (NCCL, and gloo on host
and CUDA tensors alike) and point-to-point ``batch_isend_irecv``.

- :func:`all_reduce` is differentiable: its gradient is the all-reduce
  of the incoming gradients, the adjoint of a sum every rank reads.
- :func:`gather_slots` is an all-gather written as an all-reduce over a
  zero-filled ``(n, ...)`` buffer in which each rank fills its own slot:
  adding zeros is exact, so slot ``i`` holds rank ``i``'s value (a
  -0.0 comes back as +0.0, equal in value).
- :func:`all_reduce_flat` sums many tensors in one call per dtype,
  through one flat buffer (the copies in and out are exact).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

__all__ = ["all_reduce", "all_reduce_flat", "gather_slots", "group_size"]


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


def all_reduce_flat(tensors, group):
    """Sum each tensor of `tensors` over `group`; returns new tensors of
    the same shapes, one all_reduce per dtype."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def gather_slots(t, group):
    """(n, *t.shape): slot ``i`` is rank ``i``'s `t` (the rank's index
    in `group`), on every rank of `group`."""
    n = tdist.get_world_size(group=group)
    buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[tdist.get_rank(group=group)] = t
    tdist.all_reduce(buf, group=group)
    return buf
