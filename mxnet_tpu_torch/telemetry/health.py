"""mxnet_tpu_torch.telemetry.health — the step-health monitor.

A copy of ``mxnet_tpu/telemetry/health.py``, which imports no JAX.

Production training dies quietly: a step that slowed 4x, a shape drift
that recompiles every batch, a checkpoint writer silently falling
behind. :class:`StepMonitor` watches all three from the training loop
side and turns them into (a) rate-limited structured warnings through
``mxnet_tpu_torch.log`` and (b) the ``mx_anomalies_total{kind=...}`` registry
counter (mirrored to the legacy ``telemetry::anomalies`` profiler
counter so ``profiler.dumps()`` shows it too).

Detectors:

* **Slow-step outliers** — a rolling EWMA of step seconds; after a
  warmup, any step slower than ``slow_factor`` times the EWMA is
  flagged (kind ``slow_step``). The outlier still feeds the EWMA, so a
  genuine regime change (bigger batch) re-baselines within a few steps.
* **Recompilation storms** — ``attach(cached_op)`` chains onto the
  existing ``CachedOp.on_trace`` hook; traces beyond the expected
  per-op budget (default 1, i.e. the warmup compile) are flagged
  (kind ``recompile``). A new input shape every batch shows up here
  long before it shows up in the bill.
* **Checkpoint-writer backlog** — ``watch_checkpoint(manager)`` polls
  ``CheckpointManager.pending`` at every observed step; a backlog at or
  above ``checkpoint_backlog`` means saves are queuing faster than the
  writer commits (kind ``checkpoint_backlog``).

The clock is injectable (``clock=``) so detection logic is testable
with a fake clock; durations are always *passed in* (``observe_step``)
or measured by the ``step()`` context manager with the same clock.
"""
from __future__ import annotations

import time

from . import metrics as _metrics
from . import trace as _trace
from . import xtrace as _xtrace
from .. import log as _log

__all__ = ["StepMonitor"]


class StepMonitor:
    """Parameters
    ----------
    slow_factor : float — a step slower than ``slow_factor * EWMA`` is
        an anomaly (k of the >k·EWMA rule).
    alpha : float — EWMA weight of the newest step.
    warmup_steps : int — steps observed before slow-step detection arms
        (compile steps would otherwise flag themselves).
    expected_traces : int — per-attached-op trace budget before each
        further trace counts as a recompile anomaly.
    checkpoint_backlog : int — pending async saves at/above this flag a
        backlog anomaly.
    warn_interval_s : float — per-kind floor between emitted warnings
        (suppressed repeats are counted onto the next line).
    clock : callable -> seconds — injectable for tests.
    logger : warnings sink (default ``mxnet_tpu_torch.log.get_logger``).
    """

    def __init__(self, slow_factor=3.0, alpha=0.2, warmup_steps=5,
                 expected_traces=1, checkpoint_backlog=2,
                 warn_interval_s=30.0, clock=time.perf_counter,
                 logger=None):
        self.slow_factor = float(slow_factor)
        self.alpha = float(alpha)
        self.warmup_steps = int(warmup_steps)
        self.expected_traces = int(expected_traces)
        self.checkpoint_backlog = int(checkpoint_backlog)
        self.warn_interval_s = float(warn_interval_s)
        self._clock = clock
        self._logger = logger if logger is not None else \
            _log.get_logger("mxnet_tpu_torch.telemetry")
        self._ewma = None
        self._steps = 0
        self._managers = []
        self.anomaly_counts = {}    # kind -> count (this monitor)
        # Anomaly observers (kind, msg): the flight recorder's
        # subscription seam (telemetry.recorder.FlightRecorder.attach).
        # Observers run inline on the detecting thread — at the moment
        # of failure, before the evidence is gone — and must never take
        # down the loop, so each callback is exception-isolated.
        self.on_anomaly = []
        self._anomalies = _metrics.REGISTRY.counter(
            "mx_anomalies_total",
            "Step-health anomalies detected by telemetry.StepMonitor",
            labels=("kind",))
        # Legacy mirror: shows up as telemetry::anomalies in
        # profiler.dumps() alongside checkpoint::/serving:: counters.
        from .. import profiler

        self._legacy = profiler.Domain("telemetry").new_counter("anomalies")

    # -- feeding --------------------------------------------------------------

    def observe_step(self, seconds, step=None):
        """Record one step duration; runs all armed detectors. Returns
        the kinds flagged for this observation (usually empty)."""
        seconds = float(seconds)
        self._steps += 1
        flagged = []
        ewma = self._ewma
        if (ewma is not None and self._steps > self.warmup_steps
                and seconds > self.slow_factor * ewma):
            self._anomaly(
                "slow_step",
                "slow step%s: %.1f ms vs %.1f ms EWMA (>%.1fx)"
                % ("" if step is None else " %s" % (step,),
                   seconds * 1e3, ewma * 1e3, self.slow_factor))
            flagged.append("slow_step")
        self._ewma = seconds if ewma is None else \
            (1.0 - self.alpha) * ewma + self.alpha * seconds
        for manager in self._managers:
            try:
                backlog = manager.pending
            except Exception:
                continue
            if backlog >= self.checkpoint_backlog:
                self._anomaly(
                    "checkpoint_backlog",
                    "checkpoint writer backlog: %d pending saves (>= %d)"
                    % (backlog, self.checkpoint_backlog))
                flagged.append("checkpoint_backlog")
        return flagged

    def step(self, step=None):
        """``with monitor.step(i): loss = train_step(x, y)`` — times the
        block with the monitor's clock and feeds ``observe_step``."""
        return _MonitoredStep(self, step)

    def attach(self, cached_op):
        """Watch a CachedOp for recompiles by chaining onto its
        ``on_trace`` hook (the existing hook keeps firing). Returns the
        op so ``monitor.attach(CachedOp(fn))`` composes. The trace
        count lives in the hook closure — its lifetime is the op's own
        (no monitor-side table keyed by a recyclable ``id()``)."""
        previous = cached_op.on_trace
        state = {"traces": 0}

        def _hook(op):
            if previous is not None:
                previous(op)
            state["traces"] += 1
            if state["traces"] > self.expected_traces:
                self._anomaly(
                    "recompile",
                    "recompilation: %s traced %d times (expected %d) — "
                    "check input-shape churn"
                    % (getattr(getattr(op, "_op", None), "name", "op"),
                       state["traces"], self.expected_traces))

        cached_op.on_trace = _hook
        return cached_op

    def attach_fused(self, applier, expected_compiles=None):
        """Watch a fused_update.FusedApplier for recompile storms by
        chaining onto its ``on_compile`` hook (the CachedOp ``on_trace``
        pattern — the existing hook keeps firing; the same events also
        land in ``mx_fused_apply_compiles_total``).

        Only compiles AFTER the applier reached steady state count
        against the budget (default ``expected_traces``): a large or
        mixed-dtype model legitimately compiles one executable per
        chunk/per (ctx, dtype) group on its first step, which is not a
        storm. A post-warmup compile means the param-set signature
        changed (shapes/dtypes/hyperparams churning between steps) —
        that shows up here long before it shows up in step time.
        Returns the applier so ``monitor.attach_fused(trainer._applier)``
        composes."""
        budget = self.expected_traces if expected_compiles is None \
            else int(expected_compiles)
        previous = applier.on_compile
        state = {"compiles": 0}

        def _hook(a):
            if previous is not None:
                previous(a)
            if not getattr(a, "_replanning", False):
                # Fresh plan build (first apply for this entry run —
                # one per bucket on the overlapped path): expected
                # warmup compiles, not a storm.
                return
            state["compiles"] += 1
            if state["compiles"] > budget:
                self._anomaly(
                    "fused_recompile",
                    "fused optimizer apply recompiled %d times after "
                    "warmup (budget %d) — param-set signature churn "
                    "(shapes/dtypes/hyperparams changing between steps)"
                    % (state["compiles"], budget))

        applier.on_compile = _hook
        return applier

    def watch_checkpoint(self, manager):
        """Poll ``manager.pending`` at each observed step for writer
        backlog. Returns the manager."""
        self._managers.append(manager)
        return manager

    # -- reading --------------------------------------------------------------

    @property
    def ewma_seconds(self):
        return self._ewma

    @property
    def steps(self):
        return self._steps

    def snapshot(self):
        return {"steps": self._steps,
                "ewma_ms": None if self._ewma is None else
                self._ewma * 1e3,
                "anomalies": dict(self.anomaly_counts)}

    # -- checkpoint/restore of the detection baseline -------------------------

    def state_dict(self):
        """The detection baseline (step count + step-time EWMA) as small
        scalars, suitable for riding inside a CheckpointManager state
        tree next to the training state."""
        return {"kind": "step_monitor", "steps": self._steps,
                "ewma": self._ewma}

    def load_state_dict(self, state, rearm_warmup=True):
        """Seed the baseline from a :meth:`state_dict` snapshot. With
        ``rearm_warmup`` (the default) the step counter restarts at 0 so
        slow-step detection re-arms only after ``warmup_steps`` fresh
        observations: the first post-resume step pays restore + XLA
        recompile cost and would otherwise flag itself as a ``slow_step``
        outlier against the steady-state EWMA it had no part in. The
        restored EWMA still seeds the baseline, so detection converges
        in warmup_steps instead of from scratch."""
        self._ewma = None if state.get("ewma") is None \
            else float(state["ewma"])
        self._steps = 0 if rearm_warmup else int(state.get("steps", 0))

    def reset_baseline(self, keep_ewma=False):
        """Re-enter warmup (checkpoint restore with no saved monitor
        state): detection disarms for ``warmup_steps`` observations and
        — unless ``keep_ewma`` — the EWMA rebuilds from the post-resume
        regime."""
        self._steps = 0
        if not keep_ewma:
            self._ewma = None

    def record_anomaly(self, kind, msg):
        """Public anomaly entry for external detectors (aggregation
        rank-staleness, SLO burn alerts): counts into
        ``mx_anomalies_total{kind=...}`` + the legacy profiler mirror,
        drops a trace instant, and warns rate-limited per kind —
        exactly the path the built-in detectors take."""
        self._anomaly(kind, msg)

    # -- internals ------------------------------------------------------------

    def _anomaly(self, kind, msg):
        self.anomaly_counts[kind] = self.anomaly_counts.get(kind, 0) + 1
        self._anomalies.labels(kind=kind).inc()
        self._legacy.increment()
        _trace.instant("telemetry::anomaly", kind=kind)
        # Tail capture: the detecting thread usually still holds the
        # offending step's trace context — flag it so the flight
        # recorder bundles that trace's full span tree.
        _xtrace.flag_current(kind, note=msg)
        _log.warn_rate_limited(
            self._logger, "step_monitor:%d:%s" % (id(self), kind),
            self.warn_interval_s, "[telemetry:%s] %s", kind, msg,
            now=self._clock())
        for callback in list(self.on_anomaly):
            try:
                callback(kind, msg)
            except Exception as exc:   # forensics never kills the loop
                _log.warn_rate_limited(
                    self._logger,
                    "step_monitor:observer:%d" % id(callback), 30.0,
                    "anomaly observer failed: %s", exc,
                    now=self._clock())


class _MonitoredStep:
    __slots__ = ("_monitor", "_step", "_t0")

    def __init__(self, monitor, step):
        self._monitor = monitor
        self._step = step

    def __enter__(self):
        self._t0 = self._monitor._clock()
        return self

    def __exit__(self, *exc):
        self._monitor.observe_step(self._monitor._clock() - self._t0,
                                   step=self._step)
        return False
