"""Contrib samplers.

Counterpart of ``mxnet_tpu/gluon/contrib/data/sampler.py`` (reference:
python/mxnet/gluon/contrib/data/sampler.py).
"""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Visit indices with a stride: 0, k, 2k, ..., then 1, k+1, ...
    (reference sampler.py:IntervalSampler). Useful for strided
    subsequence sampling in language data."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, \
            "interval %d must not exceed length %d" % (interval, length)
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
