"""Async device prefetch — pinned staging and a side-stream copy.

Counterpart of ``mxnet_tpu/data/prefetch.py:48-161``: a producer thread
pulls assembled host batches, moves them toward the device and parks
them in a small bounded queue; ``depth=2`` is the classic double
buffer. The queue discipline, ``close()`` and the error relay are the
JAX package's. What changes is the placement: where the JAX package
enqueues ``jax.device_put``, the port's default ``place`` on a CUDA
context is a :class:`PinnedStager`:

* the host batch is copied into one of ``depth + 1`` reusable pinned
  (page-locked) staging buffers, and the host overwrites a buffer only
  after the previous copy out of it has completed (its event);
* the copy to the card is issued with ``non_blocking=True`` on a
  dedicated side ``torch.cuda.Stream``, so it overlaps the step that
  runs on the consumer's stream, and an event is recorded after it;
* the consumer (:func:`deliver`, in ``__next__``) makes its current
  stream wait on that event and calls ``Tensor.record_stream`` on the
  delivered tensors, so the caching allocator does not hand their
  memory to another tensor while the consumer's stream may still read
  them.

Telemetry at the seam: ``mx_data_wait_seconds`` (how long the training
loop blocked waiting for data) plus ``data::wait`` / ``data::put``
trace spans. Producer exceptions (a failed copy included) are captured
and re-raised in the consumer's ``next()``.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np
import torch

from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import watchdog as _watchdog

__all__ = ["DevicePrefetcher", "PinnedStager", "Placed", "deliver",
           "data_wait_seconds"]

data_wait_seconds = _tm.REGISTRY.histogram(
    "mx_data_wait_seconds",
    "Time the training loop blocked waiting for the next batch")
_batches_total = _tm.REGISTRY.counter(
    "mx_data_batches_total", "Batches delivered by the input pipeline")


def _host_tensor(x):
    """A CPU torch tensor viewing (or holding) host array `x`."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("staging expects host arrays, got a tensor "
                             "on %s" % x.device)
        return x
    data = getattr(x, "_data", None)    # a host NDArray
    if isinstance(data, torch.Tensor):
        return _host_tensor(data.detach())
    return torch.from_numpy(np.ascontiguousarray(x))


def _map_leaves(tree, fn, path=()):
    """Apply `fn(leaf, path)` to every array of a nested list/tuple/dict
    batch; other values (ints, sample ids under "ids") pass through."""
    if isinstance(tree, dict):
        return {k: (v if k == "ids" else _map_leaves(v, fn, path + (k,)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, (np.ndarray, torch.Tensor)) or \
            isinstance(getattr(tree, "_data", None), torch.Tensor):
        return fn(tree, path)
    return tree


class Placed:
    """A batch whose copy to the card was issued on a side stream:
    `event` completes when the copy has landed in `tensors`."""

    __slots__ = ("batch", "event", "tensors", "device")

    def __init__(self, batch, event, tensors, device):
        self.batch = batch
        self.event = event
        self.tensors = tensors
        self.device = device


def deliver(item):
    """Consumer side of a placed batch: order the current stream after
    its copy, and tell the allocator the current stream uses its
    tensors. Anything else passes through."""
    if not isinstance(item, Placed):
        return item
    stream = torch.cuda.current_stream(item.device)
    stream.wait_event(item.event)
    for t in item.tensors:
        t.record_stream(stream)
    return item.batch


class _Slot:
    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers = {}
        self.event = None


class PinnedStager:
    """Place host batches on a CUDA context through pinned staging
    buffers and a side stream (see the module docstring).

    ``slots`` staging buffer sets are used in turn (the prefetcher
    passes ``depth + 1``); each call returns a :class:`Placed` whose
    ``batch`` has the structure of its input with every array replaced
    by a tensor on the card. Construction raises without a CUDA device.
    """

    def __init__(self, ctx, slots=3):
        self.device = ctx.torch_device
        if self.device.type != "cuda":
            raise ValueError("PinnedStager places on a CUDA context, got "
                             "%s" % ctx)
        self.stream = torch.cuda.Stream(device=self.device)
        self._slots = [_Slot() for _ in range(max(1, int(slots)))]
        self._next = 0

    def __call__(self, batch):
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            # The previous copy out of these buffers must have landed
            # before the host overwrites them.
            slot.event.synchronize()
        copies = []

        def stage(leaf, path):
            host = _host_tensor(leaf)
            buf = slot.buffers.get(path)
            if buf is None or buf.shape != host.shape or \
                    buf.dtype != host.dtype:
                buf = torch.empty(host.shape, dtype=host.dtype,
                                  pin_memory=True)
                slot.buffers[path] = buf
            buf.copy_(host)
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(buf, non_blocking=True)
            copies.append(dev)
            return dev

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = _map_leaves(batch, stage)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot.event = event
        return Placed(out, event, copies, self.device)


class _Stop:
    """Sentinel: producer exhausted its source."""


class _Raise:
    def __init__(self, exc):
        self.exc = exc


class DevicePrefetcher:
    """Background producer over ``source`` (an iterator of host
    batches), applying ``place`` to each batch before parking it in a
    ``depth``-bounded queue.

    ``place`` defaults to a :class:`PinnedStager` when ``ctx`` is a GPU
    context, else to the identity. ``next(p)`` delivers placed batches
    in source order; a producer error re-raises here; StopIteration
    propagates once the source is drained. ``close()`` joins the thread
    (bounded) and is idempotent.
    """

    def __init__(self, source, depth=2, place=None, ctx=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if place is None and ctx is not None and ctx.device_type == "gpu":
            place = PinnedStager(ctx, slots=int(depth) + 1)
        self._source = iter(source)
        self._place = place
        self._q = _queue.Queue(maxsize=int(depth))
        self._stop = threading.Event()
        # Watchdog lane for the production side: a source pull (or a
        # copy) that wedges fires `data_hang`. Blocking on a FULL queue
        # is deliberately OUTSIDE the heartbeat: a slow consumer is
        # backpressure, not a hang.
        self._wd_lane = _watchdog.unique_lane("data")
        self._thread = threading.Thread(target=self._produce,
                                        name="mx_data_prefetch",
                                        daemon=True)
        self._thread.start()

    def _produce(self):
        while not self._stop.is_set():
            _watchdog.begin(self._wd_lane)
            try:
                batch = next(self._source)
                if self._place is not None:
                    with _trace.span("data::put"):
                        batch = self._place(batch)
            except StopIteration:
                _watchdog.end(self._wd_lane)
                self._offer(_Stop())
                return
            except BaseException as exc:   # noqa: BLE001 — relayed to consumer
                _watchdog.end(self._wd_lane)
                self._offer(_Raise(exc))
                return
            _watchdog.end(self._wd_lane)
            if not self._offer(batch):
                return

    def _offer(self, item):
        """put() that stays responsive to close() instead of blocking
        forever on a full queue nobody drains."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        waited = time.perf_counter() - t0
        _trace.complete("data::wait", t0, t0 + waited)
        data_wait_seconds.observe(waited)
        if isinstance(item, _Stop):
            self._q.put(item)            # stay terminal on re-next()
            raise StopIteration
        if isinstance(item, _Raise):
            self._q.put(item)            # stay broken, don't hang
            raise item.exc
        _batches_total.inc()
        return deliver(item)

    next = __next__

    def close(self, timeout=5.0):
        """Stop the producer and join it (idempotent); releases the
        watchdog lane once the thread is really gone (a thread still
        wedged past the join timeout keeps its lane)."""
        self._stop.set()
        try:
            while True:                   # unblock a full-queue producer
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            _watchdog.reset(self._wd_lane)
        try:                              # a batch the producer slipped
            while True:                   # in during the join would sit
                self._q.get_nowait()      # ahead of the sentinel
        except _queue.Empty:
            pass
        try:                              # next() after close() raises
            self._q.put_nowait(_Stop())   # StopIteration, never blocks
        except _queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(timeout=1.0)
        except Exception:
            pass
