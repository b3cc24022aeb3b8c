"""Dynamic micro-batcher: coalesce concurrent submits into bucket-sized
device calls.

Counterpart of ``mxnet_tpu/serving/batcher.py`` (a copy: it imports no
JAX). The policy is the standard two-trigger batch scheduler (TF Serving's
BasicBatchScheduler, Clipper's adaptive batching): dispatch as soon as a
full ``max_batch`` worth of rows is queued, OR when the oldest queued
request has waited ``max_delay_ms`` — whichever comes first. Full
batches never wait; a lone request waits at most one delay window. A
single worker thread owns all device calls, so the signature cache and
the device stream on the dispatch path stay single-threaded.

`submit()` is the thread-safe producer edge: admission control happens
under the queue lock (bounded queue, QueueFullError), expiry happens at
dispatch time (DeadlineExceededError), and every accepted request gets a
`concurrent.futures.Future` resolved by the worker.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

from .admission import DeadlineExceededError
from ..telemetry import trace as _trace
from ..telemetry import xtrace as _xtrace

__all__ = ["DynamicBatcher"]


class _Request:
    __slots__ = ("data", "rows", "future", "deadline", "t_submit", "ctx")

    def __init__(self, data, rows, deadline, t_submit):
        self.data = data
        self.rows = rows
        self.future = Future()
        self.deadline = deadline
        self.t_submit = t_submit
        # Trace context: the submitter's when active, else a new root —
        # the engine's queue_wait/device/request spans run under it.
        ctx = _xtrace.current()
        self.ctx = ctx if ctx is not None else _xtrace.new_root()


class DynamicBatcher:
    """Parameters
    ----------
    runner : callable(list[_Request], bucket:int)
        Executes one coalesced batch and resolves each request's future.
        Runs on the worker thread; an exception fails the whole batch.
    policy : BucketPolicy
    admission : AdmissionController
    metrics : ServingMetrics
    max_delay_ms : float
        Longest a queued request waits for co-batching company.
    """

    def __init__(self, runner, policy, admission, metrics, max_delay_ms=5.0):
        self._runner = runner
        self._policy = policy
        self._admission = admission
        self._metrics = metrics
        self._max_delay = max_delay_ms / 1e3
        self._q = deque()
        self._cond = threading.Condition()
        self._running = False
        self._paused = False
        self._closed = False
        self._thread = None

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            if self._thread is not None:
                return
            self._running = True
            # daemon: a leaked server must never wedge interpreter exit.
            self._thread = threading.Thread(
                target=self._loop, name="mx-serving-batcher", daemon=True)
            self._thread.start()

    def pause(self):
        """Stop dispatching; submits still enqueue. Used for draining
        control and by tests to force deterministic coalescing."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def shutdown(self, drain=True, timeout=None):
        """Stop the worker. With drain, queued requests execute first;
        without, they fail immediately. In-flight batches always finish.
        A never-started batcher has no worker to drain through, so its
        queued requests fail rather than hang."""
        with self._cond:
            self._closed = True
            self._running = False
            self._paused = False
            if not drain or self._thread is None:
                while self._q:
                    req = self._q.popleft()
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(
                            RuntimeError("inference server shut down"))
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout if timeout is not None else 30)

    # -- producer edge --------------------------------------------------------

    def submit(self, data, rows, timeout_ms=None):
        if not 1 <= rows <= self._policy.max_batch:
            raise ValueError("rows must be in [1, %d], got %d"
                             % (self._policy.max_batch, rows))
        now = time.perf_counter()
        deadline = self._admission.deadline_for(timeout_ms, now=now)
        req = _Request(data, rows, deadline, now)
        with self._cond:
            if self._closed:
                raise RuntimeError("inference server is shut down")
            try:
                self._admission.admit(len(self._q))
            except Exception:
                self._metrics.record_shed("queue_full")
                raise
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify_all()
        with _xtrace.activate(req.ctx):
            _trace.instant("serving::enqueue", rows=rows, depth=depth)
        return req.future

    @property
    def pending(self):
        with self._cond:
            return len(self._q)

    # -- worker ---------------------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while self._running and (self._paused or not self._q):
                    self._cond.wait(0.1)
                if not self._q:
                    if not self._running:
                        return
                    continue
                self._shed_expired_locked()
                if not self._q:  # shedding may have drained the queue
                    continue
                batch = self._collect_locked()
                if batch is None:
                    continue
            # Marking RUNNING makes later set_result safe: cancel() can
            # no longer win a race against the resolution below. Clients
            # that already cancelled are dropped before device work.
            batch = [r for r in batch
                     if r.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            bucket = self._policy.bucket_for(sum(r.rows for r in batch))
            try:
                self._runner(batch, bucket)
            except Exception as exc:  # fail the batch, keep serving
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)

    # Shedding tolerance: a request expired by less than this is served
    # late rather than shed — losing the dispatch-at-deadline race to
    # scheduler jitter must not turn into a spurious error.
    _SHED_GRACE = 10e-3

    def _shed_expired_locked(self):
        now = time.perf_counter()
        live = deque()
        while self._q:
            req = self._q.popleft()
            if req.future.cancelled():
                continue  # client gave up; no device work, no shed count
            if (req.deadline is not None
                    and now > req.deadline + self._SHED_GRACE):
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(DeadlineExceededError(
                        "request expired after %.1f ms in queue"
                        % ((now - req.t_submit) * 1e3)))
                self._metrics.record_shed("deadline")
                # Tail capture: mark the expired request's trace so the
                # next flight-recorder bundle carries its span tree.
                _xtrace.flag(req.ctx, "deadline_exceeded")
            else:
                live.append(req)
        self._q = live

    # How close to a request's deadline the batcher stops waiting for
    # co-batching company and dispatches what it has instead.
    _DEADLINE_MARGIN = 2e-3

    def _collect_locked(self):
        """FIFO prefix of the queue filling at most max_batch rows.
        Returns None (after waiting) when it pays to keep coalescing."""
        take, rows = [], 0
        for req in self._q:
            if rows + req.rows > self._policy.max_batch:
                break
            take.append(req)
            rows += req.rows
        if (rows < self._policy.max_batch
                and self._running and not self._paused):
            now = time.perf_counter()
            wait = self._max_delay - (now - self._q[0].t_submit)
            # A deadline due inside the batching window caps the wait:
            # dispatch just before expiry instead of shedding a request
            # the idle device had plenty of time to serve.
            for req in take:
                if req.deadline is not None:
                    wait = min(wait,
                               req.deadline - now - self._DEADLINE_MARGIN)
            if wait > 0:
                # Wait out the capped window (or an earlier notify from
                # a new submit) and re-evaluate.
                self._cond.wait(wait)
                return None
        for _ in take:
            self._q.popleft()
        return take
