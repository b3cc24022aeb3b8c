"""Samplers (reference: python/mxnet/gluon/data/sampler.py).

Counterpart of ``mxnet_tpu/gluon/data/sampler.py``. ``RandomSampler``
draws from an explicit generator (a ``numpy.random.RandomState``,
default one seeded from ``mx.random.seed``) where the JAX package draws
from the global ``numpy.random``: seeding both alike gives the same
orders, epoch after epoch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """Abstract index sampler (reference sampler.py:Sampler)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length, rng=None):
        self._length = length
        if rng is None:
            from ... import random as _random

            rng = np.random.RandomState(_random.host_seed())
        self._rng = rng

    def __iter__(self):
        indices = np.arange(self._length)
        self._rng.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Groups an index sampler into batches (reference
    sampler.py:BatchSampler).

    ``last_batch`` picks the policy for a short final batch: ``'keep'``
    yields it as-is, ``'discard'`` drops it, ``'rollover'`` carries its
    indices into the first batch of the next epoch.
    """

    _POLICIES = ("keep", "discard", "rollover")

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in self._POLICIES:
            raise ValueError("invalid last_batch %r: choose from %s"
                             % (last_batch, "/".join(self._POLICIES)))
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._carry = []  # indices rolled over from the previous epoch

    def __iter__(self):
        pending = list(self._carry)
        self._carry = []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) >= self._batch_size:
                yield pending
                pending = []
        if not pending:
            return
        if self._last_batch == "keep":
            yield pending
        elif self._last_batch == "rollover":
            self._carry = pending
        # 'discard': short tail is dropped

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return -(-n // self._batch_size)  # ceil
        if self._last_batch == "rollover":
            n += len(self._carry)
        return n // self._batch_size
