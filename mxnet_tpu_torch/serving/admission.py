"""Admission control — bounded queueing and deadline shedding.

Counterpart of ``mxnet_tpu/serving/admission.py``. Under overload an
unbounded batching queue turns excess load into unbounded latency for
every request, so the server rejects at the door once the queue is full
(``QueueFullError``) and sheds queued requests whose deadline has
passed (``DeadlineExceededError``). The readiness gate of the JAX
package rides on its health plane, which the port does not have yet.
"""
from __future__ import annotations

import time

__all__ = ["QueueFullError", "DeadlineExceededError", "AdmissionController"]


class QueueFullError(RuntimeError):
    """Raised by submit() when the pending queue is at capacity."""


class DeadlineExceededError(RuntimeError):
    """Set on a request's future when it expired before executing."""


class AdmissionController:
    """Policy object consulted by the batcher at enqueue and dispatch.

    Parameters
    ----------
    max_queue : int
        Maximum number of requests waiting (in-flight batches excluded).
    default_timeout_ms : float, optional
        Deadline applied to requests that pass no explicit timeout; None
        means such requests never expire in the queue.
    """

    def __init__(self, max_queue=128, default_timeout_ms=None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1, got %r" % (max_queue,))
        self.max_queue = max_queue
        self.default_timeout_ms = default_timeout_ms

    def admit(self, queue_len):
        """Raise QueueFullError when a new request must be rejected."""
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
