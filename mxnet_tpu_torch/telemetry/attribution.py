"""mxnet_tpu_torch.telemetry.attribution — "where did the step go": per-step
phase decomposition and bound-cause classification.

Counterpart of ``mxnet_tpu/telemetry/attribution.py``, copied but for
two points: the device bracket waits on a CUDA event where the JAX
package calls ``jax.block_until_ready``, and no compile seam reports
an executable's cost (see :func:`record_executable_cost`).

``data.pipeline.stall_fraction`` answers one question (how much of the
loop blocked on input); this module generalizes it into the full
accounting a fleet dashboard needs. :class:`StepAttribution` derives a
per-window phase decomposition from the trace spans the subsystems
already emit plus ONE new span — ``train_step::device``, a
bracket TrainStep records after dispatch (a CUDA event recorded after
the step's work, then synchronised) when
device spans are enabled (they are enabled by constructing a
StepAttribution; off by default, because forcing a host sync per step
serializes the async dispatch pipeline the rest of the framework is
built around):

=================  ==========================================================
``data_wait``      ``data::wait`` — the loop blocked on the input pipeline
``h2d``            ``train_step::data_put`` — host→device placement on the
                   step thread
``dispatch``       ``train_step::dispatch`` — host-side trace/enqueue of the
                   fused step executable
``device_compute`` ``train_step::device`` — the device bracket:
                   what the device is still chewing after dispatch returned
``allreduce``      ``trainer::allreduce`` — the imperative Trainer's bucketed
                   gradient sync (the TrainStep path's all-reduce lands in
                   dispatch or device_compute)
``checkpoint``     ``checkpoint::snapshot`` — the synchronous slice of an
                   async save (the write/commit spans run on the writer
                   thread, off the step path)
``other``          step + wait wall time no phase claims (GIL, callbacks,
                   metric hooks, python)
=================  ==========================================================

Cumulative seconds land in ``mx_step_phase_seconds{phase}``; each
evaluation window additionally classifies the **bound cause** into the
one-hot ``mx_step_bound{cause}`` gauge (``input-bound`` /
``compute-bound`` / ``comm-bound`` / ``host-bound``) and raises an
``input_bound`` anomaly through the StepMonitor when the data share
stays above threshold for K consecutive windows — the "your accelerator
is starving" page, fired from measurements, not vibes.

The JAX package also records each XLA executable's
``cost_analysis()`` flops and bytes here (``mx_executable_flops{site}``,
``mx_executable_bytes{site}``). PyTorch runs eagerly and has no
executable to analyse, so in the port :func:`record_executable_cost`
keeps its interface and nothing calls it: ``executable_costs()`` is
empty and ``/debug/attribution`` shows no ``executables`` entries.

Span consumption is **non-destructive**: the evaluator snapshots the
live trace rings (``trace.chrome_trace``) and advances a
span-*end-time* watermark, so streaming export, flight-recorder span
tails and attribution all read the same rings without stealing from
each other.
"""
from __future__ import annotations

import threading
import time

from . import metrics as _metrics
from . import trace as _trace
from .. import log as _log

__all__ = ["StepAttribution", "PHASES", "BOUND_CAUSES",
           "set_device_spans", "device_spans_enabled",
           "record_executable_cost", "executable_costs"]

PHASES = ("data_wait", "h2d", "dispatch", "device_compute", "allreduce",
          "checkpoint", "other")
BOUND_CAUSES = ("input-bound", "compute-bound", "comm-bound",
                "host-bound")

# Span name -> phase. Spans INSIDE train_step::step partition the step;
# data::wait sits between steps (the loop blocked before calling).
_SPAN_PHASE = {
    "data::wait": "data_wait",
    "train_step::data_put": "h2d",
    "train_step::dispatch": "dispatch",
    "train_step::device": "device_compute",
    "trainer::allreduce": "allreduce",
    "checkpoint::snapshot": "checkpoint",
}

_phase_seconds = _metrics.REGISTRY.counter(
    "mx_step_phase_seconds",
    "Cumulative step wall time attributed per phase (data_wait / h2d / "
    "dispatch / device_compute / allreduce / checkpoint / other)",
    labels=("phase",))
_bound_gauge = _metrics.REGISTRY.gauge(
    "mx_step_bound",
    "One-hot bound-cause classification of the last attribution window "
    "(input-bound / compute-bound / comm-bound / host-bound)",
    labels=("cause",))
_flops_gauge = _metrics.REGISTRY.gauge(
    "mx_executable_flops",
    "cost_analysis() flops of the newest executable compiled/loaded at "
    "each maybe_cached_jit site", labels=("site",))
_bytes_gauge = _metrics.REGISTRY.gauge(
    "mx_executable_bytes",
    "cost_analysis() bytes accessed of the newest executable at each "
    "maybe_cached_jit site", labels=("site",))

# Device-span switch (the train_step::device bracket).
# A list cell, the metrics._enabled idiom: modules that cached a
# reference still see flips.
_device_spans = [False]


def set_device_spans(on):
    """Enable/disable the ``train_step::device`` bracket in ``TrainStep.__call__`` (returns the previous state).
    Constructing a :class:`StepAttribution` turns it on; leave it off
    when you are not attributing — the bracket makes every step
    host-synchronous."""
    prev = _device_spans[0]
    _device_spans[0] = bool(on)
    return prev


def device_spans_enabled():
    return _device_spans[0]


# -- executable cost accounting (the compile seam reports here) ---------------

_costs = {}                 # site -> {key, flops, bytes_accessed, ...}
_costs_lock = threading.Lock()


def _cost_scalar(analysis, field):
    """cost_analysis() returns one dict (or a per-device list of them)
    of float properties; absent fields are None."""
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0] if analysis else {}
    try:
        value = analysis.get(field)
    except AttributeError:
        return None
    return None if value is None else float(value)


def record_executable_cost(site, compiled, key=None):
    """Record one compiled/loaded executable's ``cost_analysis()``
    flops + bytes under its compile site. Failures return None — cost
    analysis is advisory (deserialized executables on some backends
    cannot produce it) and must never fail a dispatch.

    No seam of the port calls this: PyTorch has no compiled executable
    whose cost could be read, so no entry is ever recorded unless a
    caller passes an object with ``cost_analysis()`` itself."""
    try:
        analysis = compiled.cost_analysis()
    except Exception:
        return None
    flops = _cost_scalar(analysis, "flops")
    nbytes = _cost_scalar(analysis, "bytes accessed")
    if flops is None and nbytes is None:
        return None
    rec = {"key": key, "flops": flops, "bytes_accessed": nbytes,
           "recorded": time.time()}
    with _costs_lock:
        _costs[str(site)] = rec
    if flops is not None:
        _flops_gauge.labels(site=str(site)).set(flops)
    if nbytes is not None:
        _bytes_gauge.labels(site=str(site)).set(nbytes)
    return rec


def executable_costs():
    """``{site: {key, flops, bytes_accessed, recorded}}`` — the newest
    per-site executable cost records (empty in the port)."""
    with _costs_lock:
        return {site: dict(rec) for site, rec in _costs.items()}


def reset_costs():
    """Forget recorded executable costs (test isolation)."""
    with _costs_lock:
        _costs.clear()


# -- the attributor -----------------------------------------------------------

class StepAttribution:
    """Windowed step-phase attribution over the live trace rings.

    Parameters
    ----------
    monitor : StepMonitor, optional — ``input_bound`` anomalies fire
        through it.
    interval_s : evaluation window for ``tick()`` (default 15 s).
    input_bound_share : data_wait share of (wait + step) at/above which
        a window counts as input-bound (default 0.3 — the accelerator
        idles 30% of the loop on input).
    input_bound_windows : consecutive input-bound windows before the
        ``input_bound`` anomaly fires (default 3; it refires per
        further window while the condition holds, rate-limited by the
        monitor's warn interval).
    device_spans : enable the ``train_step::device`` bracket for the
        lifetime of this attributor (default True; restored on
        ``close()``).
    clock : injectable clock for tests (seconds; also used for the
        tick cadence).

    Drive it with ``tick()`` from the training loop (one ring snapshot
    per ``interval_s``) or ``update()`` for an immediate evaluation.
    """

    def __init__(self, monitor=None, interval_s=15.0,
                 input_bound_share=0.3, input_bound_windows=3,
                 device_spans=True, clock=time.monotonic):
        self._monitor = monitor
        self.interval_s = float(interval_s)
        self.input_bound_share = float(input_bound_share)
        self.input_bound_windows = int(input_bound_windows)
        self._clock = clock
        self._restore_device_spans = None
        if device_spans:
            self._restore_device_spans = set_device_spans(True)
        self._last_tick = None
        # Watermark over span END times (µs, trace's perf_counter
        # base): a span is consumed once its end crosses the watermark.
        # End times are ~append times, so per-thread they are
        # monotonic; a cross-thread straggler can slip a window — this
        # is attribution, not accounting.
        self._watermark_us = -float("inf")
        self._streak = 0            # consecutive input-bound windows
        self.windows = 0
        self.cumulative = {phase: 0.0 for phase in PHASES}
        self.last_window = None     # {phase: seconds} of the last eval
        self.last_shares = None     # {phase: share} of the last eval
        self.bound_cause = None

    # -- evaluation -----------------------------------------------------------

    def _collect_window(self, events=None):
        """Sum per-phase seconds from events whose END passed the
        watermark. Returns ({phase: s}, step_s): phase sums plus the
        train_step::step wall time of the window."""
        if events is None:
            events = _trace.chrome_trace()["traceEvents"]
        sums = {phase: 0.0 for phase in PHASES}
        step_s = 0.0
        new_mark = self._watermark_us
        for event in events:
            if event.get("ph") != "X":
                continue
            end = event.get("ts", 0.0) + event.get("dur", 0.0)
            if end <= self._watermark_us:
                continue
            if end > new_mark:
                new_mark = end
            name = event.get("name")
            dur_s = event.get("dur", 0.0) / 1e6
            if name == "train_step::step":
                step_s += dur_s
                continue
            phase = _SPAN_PHASE.get(name)
            if phase is not None:
                sums[phase] += dur_s
        self._watermark_us = new_mark
        # "other": loop wall time no phase claims. The step span covers
        # data_put + dispatch + device; data_wait sits outside it.
        accounted = sum(sums[p] for p in
                        ("h2d", "dispatch", "device_compute",
                         "allreduce", "checkpoint"))
        sums["other"] = max(0.0, step_s - accounted)
        # Loop time for the share denominator. The imperative Trainer
        # path emits phase spans (trainer::allreduce, checkpoint) but
        # no train_step::step envelope — there the accounted phases ARE
        # the best loop-time estimate; without this, shares divide by
        # data_wait alone, exceed 1.0, and a comm-bound Trainer loop
        # pages as input-bound.
        loop_s = step_s if step_s > 0.0 else accounted
        return sums, loop_s

    def update(self, events=None):
        """One evaluation pass: consume new spans, bump the phase
        counters, classify the bound cause, run the input-bound
        detector. Returns the window's ``{phase: seconds}``."""
        sums, loop_s = self._collect_window(events)
        for phase, seconds in sums.items():
            if seconds > 0.0:
                _phase_seconds.labels(phase=phase).inc(seconds)
            self.cumulative[phase] += seconds
        self.windows += 1
        total = sums["data_wait"] + loop_s
        self.last_window = dict(sums)
        if total <= 0.0:
            self.last_shares = None
            return sums
        shares = {phase: sums[phase] / total for phase in PHASES}
        self.last_shares = shares
        self._classify(shares)
        return sums

    def _classify(self, shares):
        """One-hot bound cause. input-bound wins outright past its
        threshold (a starving accelerator is THE problem regardless of
        what the remaining time does); otherwise the largest of
        device/comm/host shares names the bound."""
        if shares["data_wait"] >= self.input_bound_share:
            cause = "input-bound"
            self._streak += 1
            if self._streak >= self.input_bound_windows and \
                    self._monitor is not None:
                self._monitor.record_anomaly(
                    "input_bound",
                    "input-bound: data_wait is %.0f%% of the loop for "
                    "%d consecutive windows (threshold %.0f%%) — the "
                    "accelerator is starving; grow decode workers or "
                    "shard the input"
                    % (shares["data_wait"] * 100.0, self._streak,
                       self.input_bound_share * 100.0))
        else:
            self._streak = 0
            host = shares["dispatch"] + shares["h2d"] + shares["other"]
            candidates = (("compute-bound", shares["device_compute"]),
                          ("comm-bound", shares["allreduce"]),
                          ("host-bound", host))
            cause = max(candidates, key=lambda c: c[1])[0]
        self.bound_cause = cause
        for name in BOUND_CAUSES:
            _bound_gauge.labels(cause=name).set(int(name == cause))

    def tick(self):
        """Step-loop cadence call: one :meth:`update` per
        ``interval_s``; never raises."""
        now = self._clock()
        if self._last_tick is not None and \
                now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now
        try:
            return self.update()
        except Exception as exc:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "attribution:%d" % id(self), 60.0,
                "step attribution pass failed (will retry): %s", exc)
            return None

    # -- reading --------------------------------------------------------------

    def snapshot(self):
        """JSON-able state for ``/debug/attribution`` and bundles."""
        return {
            "phases": {p: round(self.cumulative[p], 6) for p in PHASES},
            "last_window": None if self.last_window is None else
            {p: round(s, 6) for p, s in self.last_window.items()},
            "last_shares": None if self.last_shares is None else
            {p: round(s, 4) for p, s in self.last_shares.items()},
            "bound_cause": self.bound_cause,
            "input_bound_streak": self._streak,
            "windows": self.windows,
            "executables": executable_costs(),
        }

    def close(self):
        """Restore the device-span switch to its pre-attribution
        state."""
        if self._restore_device_spans is not None:
            set_device_spans(self._restore_device_spans)
            self._restore_device_spans = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
