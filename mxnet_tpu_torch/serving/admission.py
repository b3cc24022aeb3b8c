"""Admission control — bounded queueing, deadline shedding, readiness.

Counterpart of ``mxnet_tpu/serving/admission.py`` (a copy: it imports no
JAX). Under overload an unbounded batching queue turns excess offered
load into unbounded latency for every request (the queue only drains at
device speed). Production batchers (Clipper, TF Serving) degrade
gracefully instead: reject at the door once the queue is full
(``QueueFullError``: the client can back off or retry elsewhere), and
shed queued requests whose deadline already passed (running the model
for a caller that has given up wastes device time that live requests
need).

Readiness-aware admission closes the third gap: while the health
plane's ``/readyz`` is false (a component still warming its buckets),
queueing a request only guarantees it blows its deadline behind the
warmup, so it is shed at the door instead (``ServiceUnavailableError``,
the HTTP-503 semantics a load balancer retries elsewhere).
"""
from __future__ import annotations

import time

__all__ = ["QueueFullError", "DeadlineExceededError",
           "ServiceUnavailableError", "AdmissionController"]


class QueueFullError(RuntimeError):
    """Raised by submit() when the pending queue is at capacity."""


class DeadlineExceededError(RuntimeError):
    """Set on a request's future when it expired before executing."""


class ServiceUnavailableError(RuntimeError):
    """Raised by submit() while the process is not ready (``/readyz``
    false — warmup still in flight): the 503 shed, so callers retry
    another replica instead of queueing behind the warmup."""


class AdmissionController:
    """Policy object consulted by the batcher at enqueue and dispatch.

    Parameters
    ----------
    max_queue : int
        Maximum number of requests waiting (in-flight batches excluded).
    default_timeout_ms : float, optional
        Deadline applied to requests that pass no explicit timeout.
        None means such requests never expire in the queue.
    readiness : callable() -> bool, optional
        Readiness gate consulted on every admit (pass
        ``telemetry.healthplane.is_ready`` to mirror ``/readyz``).
        While it returns False new requests are shed with
        :class:`ServiceUnavailableError` instead of queued.
    """

    def __init__(self, max_queue=128, default_timeout_ms=None,
                 readiness=None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1, got %r" % (max_queue,))
        self.max_queue = max_queue
        self.default_timeout_ms = default_timeout_ms
        self.readiness = readiness

    def admit(self, queue_len):
        """Raise ServiceUnavailableError while the readiness gate is
        down, QueueFullError when a new request must be rejected."""
        if self.readiness is not None and not self.readiness():
            raise ServiceUnavailableError(
                "not ready (/readyz false): warmup still in flight — "
                "retry another replica")
        if queue_len >= self.max_queue:
            raise QueueFullError(
                "serving queue full (%d pending, max_queue=%d)"
                % (queue_len, self.max_queue))

    def deadline_for(self, timeout_ms=None, now=None):
        """Absolute monotonic deadline for a request, or None."""
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        if timeout_ms is None:
            return None
        return (now if now is not None else time.perf_counter()) \
            + timeout_ms / 1e3
