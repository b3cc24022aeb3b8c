"""mxnet_tpu_torch.telemetry.memstats — device memory and compile accounting.

Counterpart of ``mxnet_tpu/telemetry/memstats.py``. The JAX package
samples PJRT's ``device.memory_stats()`` and walks ``jax.live_arrays()``
where a backend has no counters; the port samples PyTorch's caching
allocator, and walks the live torch tensors where no card is in use.

* **Device memory.** ``mx_device_live_buffers{device}`` /
  ``mx_device_live_bytes{device}`` / ``mx_device_peak_bytes{device}``
  gauges. For each CUDA device (``cuda:<i>``), from
  ``torch.cuda.memory_stats(i)``: in use is
  ``allocated_bytes.all.current`` (``torch.cuda.memory_allocated``),
  the peak ``allocated_bytes.all.peak``
  (``torch.cuda.max_memory_allocated``), the buffers the active blocks
  (``active.all.current``), and each sample also carries the card's
  total memory as its limit. :func:`reset_peak` resets the allocator's
  peak (``torch.cuda.reset_peak_memory_stats``). A process that has not
  initialised CUDA itself samples the live torch tensors on the host
  instead (device ``cpu``; its peak a high-watermark over samples), and
  a sample never initialises CUDA: a kvstore server or scheduler keeps
  ``torch.cuda.is_initialized()`` False. ``sample()`` is a point read —
  call it on a step cadence, run a :class:`DeviceMemoryMonitor` for a
  background cadence, or let a flight-recorder bundle capture one at
  the moment of failure.

* **Compile time.** ``mx_compile_seconds{site}`` histogram, fed by
  three seams (``site`` is the seam, not the op — bounded
  cardinality). PyTorch runs eagerly and compiles nothing, so a
  "compile" here is the call that fills what the JAX package would
  compile: ``cached_op`` (a CachedOp's call with a new input
  signature, the ``num_traces``/``on_trace`` event the recompile
  detector watches), ``fused_apply`` (FusedApplier's first apply of a
  freshly planned chunk) and ``train_step`` (TrainStep's first call).
  Each observation is that call's wall time, which is the cold-start
  cost of the signature.
"""
from __future__ import annotations

import threading
import time

from . import metrics as _metrics
from .. import log as _log

__all__ = ["DeviceMemoryMonitor", "sample_device_memory", "reset_peak",
           "observe_compile", "compile_stats"]

_live_buffers = _metrics.REGISTRY.gauge(
    "mx_device_live_buffers",
    "Live device buffers (the CUDA allocator's active blocks, else "
    "the live torch tensors of the host)", labels=("device",))
_live_bytes = _metrics.REGISTRY.gauge(
    "mx_device_live_bytes",
    "Bytes held by live device buffers", labels=("device",))
_peak_bytes = _metrics.REGISTRY.gauge(
    "mx_device_peak_bytes",
    "Peak of mx_device_live_bytes (the CUDA allocator's peak, else a "
    "high-watermark over samples)",
    labels=("device",))
_compile_seconds = _metrics.REGISTRY.histogram(
    "mx_compile_seconds",
    "Wall time of the call that met a new signature (CachedOp input "
    "signature, fused-apply chunk, TrainStep first step) per site",
    labels=("site",))

# Host-side peak watermark of the host fallback (no allocator peak
# counter there): survives across samples, reset via reset_peak().
_peaks = {}
_peaks_lock = threading.Lock()


def observe_compile(site, seconds):
    """Record one executable-cache fill into
    ``mx_compile_seconds{site=...}``. Called from the CachedOp /
    FusedApplier / TrainStep seams; available to other seams too."""
    _compile_seconds.labels(site=site).observe(float(seconds))


def compile_stats():
    """``{site: {count, total_s, p50_s, p99_s}}`` summary of every
    compile site observed so far (the recorder-bundle / REPL view)."""
    out = {}
    for (site,), child in _compile_seconds.collect():
        snap = child.snapshot()
        if not snap["count"]:
            continue
        out[site] = {"count": snap["count"], "total_s": snap["sum"],
                     "p50_s": child.quantile(0.5),
                     "p99_s": child.quantile(0.99)}
    return out


def _stats_sample():
    """Per CUDA device this process has initialised: (buffers, bytes in
    use, peak, limit) from ``torch.cuda.memory_stats``. A process that
    has not initialised CUDA (a kvstore server, the scheduler, a host
    run) samples no card: the sample must not initialise it."""
    import torch

    out = {}
    if not torch.cuda.is_initialized():
        return out
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue        # a card this process never allocated on
        out["cuda:%d" % d] = (
            int(stats.get("active.all.current", 0)) or None,
            int(stats["allocated_bytes.all.current"]),
            int(stats["allocated_bytes.all.peak"]),
            int(torch.cuda.get_device_properties(d).total_memory))
    return out


def _live_tensor_sample():
    """The host's fallback: the live torch tensors of this process on
    the CPU, found through the garbage collector, their storages counted
    once each. O(live objects): fine on a sampling cadence."""
    import gc

    import torch

    seen = set()
    count = nbytes = 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: isinstance reads __class__, which
            # some module proxies answer with a deprecation warning.
            if not issubclass(type(obj), torch.Tensor) or \
                    obj.device.type != "cpu":
                continue
            storage = obj.untyped_storage()
            key = storage.data_ptr()
            if key in seen:
                continue
            seen.add(key)
            count += 1
            nbytes += int(storage.nbytes())
        except (RuntimeError, ReferenceError):
            continue        # freed or opaque mid-walk: skip, not fatal
    return count, nbytes


def sample_device_memory(update_gauges=True):
    """One point-in-time device-memory sample. Returns
    ``{device: {"buffers", "bytes", "peak_bytes", "limit_bytes"}}`` and
    (by default) writes the three gauges. A card's peak is the
    allocator's own counter; the host fallback's is the high-watermark
    of samples taken so far, and its limit None."""
    stats = _stats_sample()
    if not stats:
        count, nbytes = _live_tensor_sample()
        stats["cpu"] = (count, nbytes, None, None)
    out = {}
    with _peaks_lock:
        for dev, (buffers, in_use, backend_peak, limit) in stats.items():
            peak = backend_peak if backend_peak is not None else \
                max(_peaks.get(dev, 0), in_use)
            _peaks[dev] = peak
            out[dev] = {"buffers": buffers, "bytes": in_use,
                        "peak_bytes": peak, "limit_bytes": limit}
    if update_gauges:
        for dev, rec in out.items():
            if rec["buffers"] is not None:
                _live_buffers.labels(device=dev).set(rec["buffers"])
            _live_bytes.labels(device=dev).set(rec["bytes"])
            _peak_bytes.labels(device=dev).set(rec["peak_bytes"])
    return out


def reset_peak():
    """Reset the peak (tests, phase boundaries): the CUDA allocator's
    peak counters of the cards this process uses
    (``torch.cuda.reset_peak_memory_stats``) and the host watermark."""
    import torch

    with _peaks_lock:
        _peaks.clear()
        if torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(d)


class DeviceMemoryMonitor:
    """Background device-memory sampling on a fixed cadence.

    ``tick()`` from the step loop (samples at most once per
    ``interval_s``) or ``start()`` a daemon thread; either way the
    gauges and the peak watermark stay current so an anomaly bundle or
    a scrape always has a recent memory picture. Sampling failures are
    warned rate-limited and retried — accounting never takes down the
    loop."""

    def __init__(self, interval_s=10.0, clock=time.monotonic):
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last = None
        self._stop = threading.Event()
        self._thread = None
        self.last_sample = None

    def sample(self):
        self.last_sample = sample_device_memory()
        return self.last_sample

    def tick(self):
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            return None
        self._last = now
        try:
            return self.sample()
        except Exception as exc:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "memstats:%d" % id(self), 60.0,
                "device memory sample failed (will retry): %s", exc)
            return None

    def start(self):
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    self.tick()

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-memstats", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
