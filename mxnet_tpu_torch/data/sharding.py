"""Deterministic, equal-size sharding of a sample space across ranks.

Counterpart of ``mxnet_tpu/data/sharding.py`` (a copy: that module
imports no JAX, but the port imports nothing of the JAX package).
``epoch_order`` gives the JAX package's permutation for the same
``(seed, epoch)``: both draw it from the same Philox ``SeedSequence``.

The reference shards an epoch with ``num_parts``/``part_index`` integer
division (iter_mnist.cc, ImageIter) — which TRUNCATES: with 10 records
over 3 parts each part gets 3 and record 9 is silently unreachable, and
(worse for SPMD) parts can disagree in size, so ranks diverge in step
count and a collective hangs. Everything here gives the opposite
guarantee:

* **equal-size**: every shard has exactly ``ceil(n / num_shards)``
  samples — all ranks run the same number of steps per epoch;
* **total coverage**: every sample id appears in some shard at least
  once per epoch; the ``num_shards*per - n`` tail slots wrap around to
  the head of the (shuffled) epoch order, so at most one extra
  occurrence per sample;
* **deterministic**: the epoch order is a pure function of
  ``(seed, epoch)`` — identical on every rank, across restarts and
  processes, which is what makes iterator checkpoint/resume bit-exact.
"""
from __future__ import annotations

import numpy as np

__all__ = ["epoch_order", "shard_indices", "shard_slice", "num_padded",
           "resolve_shards"]


def resolve_shards(num_shards=None, shard_index=None):
    """Default shard geometry: the JAX package takes one shard per
    ``parallel.dist`` process; until the port has ``parallel.dist``
    (ROADMAP Queue 1 item 7) the defaults are one shard, index 0.
    Explicit values work. The single policy point for every pipeline
    entry surface."""
    return (1 if num_shards is None else int(num_shards),
            0 if shard_index is None else int(shard_index))


def epoch_order(n, epoch=0, seed=0, shuffle=True):
    """Permutation of ``range(n)`` for this epoch — a pure function of
    ``(seed, epoch)``, identical on every rank. ``shuffle=False`` is the
    identity order (still epoch-independent)."""
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    # SeedSequence folds (seed, epoch) into independent streams without
    # the correlation a naive `seed + epoch` reseed would give.
    rng = np.random.Generator(np.random.Philox(
        np.random.SeedSequence(entropy=int(seed),
                               spawn_key=(int(epoch),))))
    return rng.permutation(n).astype(np.int64)


def num_padded(n, num_shards):
    """Per-epoch padded sample count: ``num_shards * ceil(n/num_shards)``
    (== n when it divides evenly)."""
    if n <= 0:
        raise ValueError("empty sample space (n=%d)" % n)
    per = -(-n // num_shards)
    return per * num_shards


def shard_indices(n, num_shards=1, shard_index=0, epoch=0, seed=0,
                  shuffle=True):
    """This shard's sample ids for ``epoch``: a length-
    ``ceil(n/num_shards)`` int64 array sliced contiguously from the
    wrap-padded epoch order. Every rank calling with the same
    ``(n, num_shards, epoch, seed)`` sees one consistent partition."""
    if not 0 <= shard_index < num_shards:
        raise ValueError("shard_index %d out of range for %d shards"
                         % (shard_index, num_shards))
    order = epoch_order(n, epoch=epoch, seed=seed, shuffle=shuffle)
    per = num_padded(n, num_shards) // num_shards
    lo = shard_index * per
    # Modulo walk, not a one-shot tail concat: correct even in the
    # degenerate num_shards > n regimes where the pad exceeds n.
    return order[np.arange(lo, lo + per) % n]


def shard_slice(seq, num_parts, part_index):
    """Equal-size wrap-tail slice of an arbitrary sequence — the drop-in
    replacement for the reference's truncating ``num_parts`` division in
    MNISTIter / ImageIter. Returns the same type family as the input
    (list in -> list out, ndarray in -> ndarray out)."""
    if num_parts <= 1:
        return seq
    if not 0 <= part_index < num_parts:
        raise ValueError("part_index %d out of range for %d parts"
                         % (part_index, num_parts))
    n = len(seq)
    per = num_padded(n, num_parts) // num_parts
    lo, hi = part_index * per, (part_index + 1) * per
    if isinstance(seq, np.ndarray):
        idx = np.arange(lo, hi) % n
        return seq[idx]
    return [seq[i % n] for i in range(lo, hi)]
