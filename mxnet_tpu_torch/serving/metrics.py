"""Per-bucket serving statistics.

Counterpart of ``mxnet_tpu/serving/metrics.py``, self-contained: the JAX
package books the same events into its telemetry registry and profiler
domain, which the port does not have yet. ``snapshot()`` returns the
same shape of dict: per bucket the requests, device batches, mean
occupancy (real rows over padded rows) and p50/p99 request latency
(submit to result, queueing included), plus shed counts by reason.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

__all__ = ["ServingMetrics"]

# Latencies kept per bucket for the percentiles (the newest ones).
_LATENCY_WINDOW = 10000


class ServingMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._batches = collections.Counter()
        self._requests = collections.Counter()
        self._rows = collections.Counter()
        self._latency = collections.defaultdict(
            lambda: collections.deque(maxlen=_LATENCY_WINDOW))
        self._shed = collections.Counter()

    def record_batch(self, bucket, rows, n_requests, seconds):
        """One device call: `n_requests` coalesced into `rows` real rows,
        padded up to `bucket`, taking `seconds`."""
        with self._lock:
            self._batches[bucket] += 1
            self._requests[bucket] += n_requests
            self._rows[bucket] += rows

    def record_request_latency(self, bucket, seconds):
        with self._lock:
            self._latency[bucket].append(seconds)

    def record_shed(self, reason):
        """A request was rejected (`queue_full`) or expired (`deadline`)."""
        with self._lock:
            self._shed[reason] += 1

    def snapshot(self):
        with self._lock:
            out = {"buckets": {}, "shed": dict(self._shed)}
            for bucket in sorted(self._batches):
                n = self._batches[bucket]
                lat = np.asarray(self._latency.get(bucket, ()), np.float64)
                out["buckets"][bucket] = {
                    "requests": self._requests[bucket],
                    "batches": n,
                    "mean_occupancy": self._rows[bucket] / (n * bucket),
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3
                    if lat.size else 0.0,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3
                    if lat.size else 0.0,
                }
        return out

    @property
    def total_batches(self):
        with self._lock:
            return sum(self._batches.values())

    @property
    def total_shed(self):
        with self._lock:
            return sum(self._shed.values())
