"""Sequence operators: SequenceMask, SequenceLast, SequenceReverse.

Counterpart of the sequence half of ``mxnet_tpu/ops/sequence.py``
(:33-78; reference src/operator/sequence_mask.cc, sequence_last.cc,
sequence_reverse.cc). Data is (T, N, ...) with ``axis=0`` or (N, T,
...) with ``axis=1``; lengths, when used, are one per sequence and may
arrive as floats: they are truncated to integers, as the JAX op casts
them. The ``linalg_*`` half of that file is not ported yet (ROADMAP
Queue 1 item 11).
"""
from __future__ import annotations

import torch

from .registry import register


def _lengths(sequence_length, t):
    """Integer lengths, at most `t`: a longer one would index past the
    sequence (the JAX op's gathers clamp; a CUDA gather would assert)."""
    return torch.clamp(sequence_length.to(torch.int64), max=t)


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """`value` at every step at or past its sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    t = data.shape[axis]
    mask = torch.arange(t, device=data.device)[:, None] \
        < _lengths(sequence_length, t)[None, :]
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    last = _lengths(sequence_length, data.shape[axis]) - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    if axis == 0:
        return data[last, batch]
    return data[batch, last]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Each sequence's valid prefix reversed in time, its padding left in
    place. Time is axis 0, as in the reference, whose op supports no
    other: the port raises on another `axis` (the JAX op ignores it)."""
    if axis != 0:
        raise ValueError("SequenceReverse supports axis=0 only, got %r"
                         % (axis,))
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    t, b = data.shape[0], data.shape[1]
    lens = _lengths(sequence_length, t)[None, :]
    tt = torch.arange(t, device=data.device)[:, None]
    src = torch.where(tt < lens, lens - 1 - tt, tt)
    src = src.reshape((t, b) + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, src)
