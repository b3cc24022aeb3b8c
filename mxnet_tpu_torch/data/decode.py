"""Parallel decode pool — the thread team between the record stream and
batch assembly.

Counterpart of ``mxnet_tpu/data/decode.py``, unchanged.

The reference decodes with an OpenMP loop inside ImageRecordIOParser2
(iter_image_recordio_2.cc:145 — per-thread JPEG decode + augmenters).
Here the team is a ThreadPoolExecutor: cv2's decode/resize release the
GIL (as zlib's inflate and numpy's large copies do) so Python
threads decode in parallel, and the numpy augmenter
bodies are cheap relative to the JPEG work.

Two delivery modes:

* ``ordered=True`` (default): results come back in submission order —
  what the checkpointable pipeline requires, since the delivered-sample
  watermark only makes sense over a deterministic sequence.
* ``ordered=False``: results come back in completion order — higher
  sustained throughput when per-sample decode cost is skewed (one slow
  PNG doesn't head-of-line-block the batch), for throughput-only
  consumers that don't need resumability.

Worker exceptions are captured and re-raised at the consumption point
(the ``PrefetchingIter.prefetch_func`` lesson: a decode error must
surface in the consumer, never strand it waiting forever).

Each worker thread heartbeats its own ``data``-base watchdog lane
around every ``fn(item)`` call, so a decode wedged on dead storage (or
a poisoned augmenter loop) fires a ``data_hang`` anomaly — with that
worker's stack in the flight-recorder bundle — instead of surfacing
only as the consumer's ever-growing ``data::wait`` span. Lanes are
claimed lazily (first item per worker) and released on ``close()``.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
from concurrent.futures import ThreadPoolExecutor

from ..telemetry import watchdog as _watchdog

__all__ = ["DecodePool"]


class DecodePool:
    """Map ``fn`` over an item stream with ``num_threads`` workers and a
    bounded in-flight window (default ``2 * num_threads`` — enough to
    keep every worker busy while one batch drains, small enough that a
    checkpoint loses at most a window of re-decodable work)."""

    def __init__(self, fn, num_threads=4, ordered=True, inflight=None):
        if num_threads < 1:
            raise ValueError("num_threads must be >= 1")
        self.fn = fn
        self.num_threads = int(num_threads)
        self.ordered = bool(ordered)
        self.inflight = int(inflight) if inflight else 2 * self.num_threads
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads,
                                        thread_name_prefix="mx_data_decode")
        self._closed = False
        self._lock = threading.Lock()
        self._lanes = []            # watchdog lanes claimed by workers
        self._tls = threading.local()

    def _decode(self, item):
        """Worker body: ``fn(item)`` heartbeating this worker's
        watchdog lane (claimed on its first item, ``data``/``data#N``)
        — in-flight decode past the deadline fires ``data_hang``."""
        lane = getattr(self._tls, "lane", None)
        if lane is None:
            lane = _watchdog.unique_lane("data")
            self._tls.lane = lane
            with self._lock:
                self._lanes.append(lane)
        _watchdog.begin(lane)
        try:
            return self.fn(item)
        finally:
            _watchdog.end(lane)

    def run(self, items):
        """Generator: ``fn(item)`` for each item of the (possibly
        infinite) iterable, decoded in parallel, delivered ordered or
        unordered. Worker exceptions re-raise here."""
        return self._run_ordered(items) if self.ordered \
            else self._run_unordered(items)

    def _run_ordered(self, items):
        it = iter(items)
        window = collections.deque()
        try:
            while True:
                while len(window) < self.inflight and not self._closed:
                    try:
                        window.append(self._pool.submit(self._decode,
                                                        next(it)))
                    except StopIteration:
                        break
                if not window:
                    return
                yield window.popleft().result()   # re-raises worker errors
        finally:
            for fut in window:
                fut.cancel()

    def _run_unordered(self, items):
        it = iter(items)
        done = _queue.Queue()
        outstanding = 0

        def work(item):
            try:
                done.put((True, self._decode(item)))
            except BaseException as exc:   # noqa: BLE001 — relayed below
                done.put((False, exc))

        while True:
            while outstanding < self.inflight and not self._closed:
                try:
                    self._pool.submit(work, next(it))
                except StopIteration:
                    break
                outstanding += 1
            if not outstanding:
                return
            ok, payload = done.get()
            outstanding -= 1
            if not ok:
                raise payload
            yield payload

    def resize(self, num_threads):
        """Retarget the worker-team size (the autoscaler's lever;
        ``data.autoscale.DecodeAutoscaler`` drives this off the
        data-wait share of step time). Growing takes effect on the next
        submit — ThreadPoolExecutor spawns lazily up to its bound.
        Shrinking is best-effort: the executor cannot retire threads,
        so surplus workers go idle while the in-flight window
        (``2 * num_threads``, re-derived here) stops feeding them —
        concurrency follows the window even where thread count cannot.
        Returns the effective size."""
        n = max(1, int(num_threads))
        with self._lock:
            if self._closed or n == self.num_threads:
                return self.num_threads
            self.num_threads = n
            self.inflight = 2 * n
            pool = self._pool
        # Same-package reach into the executor's bound: submit() calls
        # _adjust_thread_count itself, so raising the bound is enough.
        pool._max_workers = n
        return n

    def close(self):
        """Shut the worker team down (idempotent) and release the
        workers' watchdog lanes — a long-lived process cycling pipelines
        must not accumulate dead ``data#N`` lanes."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)
        with self._lock:
            lanes, self._lanes = self._lanes, []
        for lane in lanes:      # workers joined: no begin() can revive
            _watchdog.reset(lane)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
