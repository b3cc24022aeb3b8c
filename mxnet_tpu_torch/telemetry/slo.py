"""mxnet_tpu_torch.telemetry.slo — multi-window SLO burn-rate alerting.

A copy of ``mxnet_tpu/telemetry/slo.py``, which imports no JAX.

The registry's latency families (``mx_serving_request_latency_seconds``,
``mx_train_step_seconds``, any fixed-bucket histogram) already hold
everything an availability SLO needs: cumulative totals and the
cumulative count under each bucket bound. This module evaluates
Google-SRE-style **multi-window burn rates** over them:

* an SLO is "fraction of events under ``threshold_s`` must be at least
  ``objective``" (e.g. 99% of requests under 250 ms);
* the *burn rate* over a window is ``error_rate / (1 - objective)`` —
  1.0 means the error budget is being consumed exactly at the sustainable
  pace, 14.4 means a 30-day budget burns in 2 days;
* an alert fires only when EVERY configured window (default 5m + 1h)
  exceeds ``alert_burn_rate`` — the short window proves the burn is
  happening *now*, the long one that it is *material*, which is what
  kills flapping alerts on latency blips.

Evaluation emits ``mx_slo_burn_rate{slo,window}`` gauges and
``mx_slo_alerts_total{slo}``, and routes alerts through the same
rate-limited anomaly path as the StepMonitor (kind ``slo_burn`` in
``mx_anomalies_total``) — one alert line per window interval, suppressed
repeats counted, never a log flood. The clock is injectable so the whole
burn-rate state machine is testable with a fake clock.

Thresholds snap **up** to the enclosing histogram bucket bound (the
registry's fixed exponential buckets): the evaluated objective is
conservative-friendly — events counted "good" are provably under the
snapped bound. ``ServiceLevelObjective.effective_threshold`` exposes the
snapped value.
"""
from __future__ import annotations

import time
from bisect import bisect_left
from collections import deque

from . import metrics as _metrics
from . import trace as _trace
from .. import log as _log

__all__ = ["ServiceLevelObjective", "BurnRateMonitor", "format_window"]


def format_window(seconds):
    """300 -> '5m', 3600 -> '1h', 90000 -> '25h', 45 -> '45s'."""
    seconds = int(seconds)
    if seconds % 3600 == 0:
        return "%dh" % (seconds // 3600)
    if seconds % 60 == 0:
        return "%dm" % (seconds // 60)
    return "%ds" % seconds


class ServiceLevelObjective:
    """One latency objective over a histogram family.

    Parameters
    ----------
    name : label value for ``mx_slo_burn_rate{slo=...}``.
    objective : target good fraction in (0, 1), e.g. 0.99.
    threshold_s : an event is "good" when <= this many seconds (snapped
        up to the family's enclosing bucket bound).
    family : a ``HistogramFamily`` (all children are summed — e.g. every
        ``(server, bucket)`` series of the serving latency family) OR a
        metric name string resolved lazily against ``registry`` (so an
        SLO can be declared before the instrumented subsystem starts).
    labels : optional ``{label: value}`` filter — only children whose
        values match every entry count (e.g. ``{"server": "srv-0"}`` to
        scope the serving family to one server instance).
    registry : where string names resolve (default process ``REGISTRY``).
    """

    def __init__(self, name, objective, threshold_s, family,
                 labels=None, registry=None):
        objective = float(objective)
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1), got %r"
                             % (objective,))
        self.name = str(name)
        self.objective = objective
        self.threshold_s = float(threshold_s)
        self._family = family
        self._labels = {k: str(v) for k, v in (labels or {}).items()}
        self._registry = registry or _metrics.REGISTRY

    @property
    def error_budget(self):
        return 1.0 - self.objective

    def _resolve(self):
        fam = self._family
        if isinstance(fam, str):
            fam = self._registry.get(fam)
        if fam is not None and fam.kind != "histogram":
            raise ValueError("SLO %r needs a histogram family, got %s"
                             % (self.name, fam.kind))
        return fam

    @property
    def effective_threshold(self):
        """The bucket bound the threshold snapped up to (None until the
        family exists)."""
        fam = self._resolve()
        if fam is None:
            return None
        idx = bisect_left(fam.buckets, self.threshold_s)
        return fam.buckets[idx] if idx < len(fam.buckets) else float("inf")

    @staticmethod
    def _label_key(fam, key):
        # Fleet-registry quirk (aggregate._rank_label): when a family
        # already used "rank" natively, the merge labels the source
        # process under "src_rank" — a fleet SLO filtering on
        # rank="all" must follow the label there. "src_rank" only ever
        # exists as the merge's process label, so its presence alone
        # decides (the native "rank" label is still in labelnames, so
        # checking `key not in labelnames` would never redirect in
        # exactly the case this fallback exists for).
        if key == "rank" and "src_rank" in fam.labelnames:
            return "src_rank"
        return key

    def totals(self):
        """Cumulative ``(bad, total)`` across every child of the family
        (0, 0 until the family exists / has traffic)."""
        fam = self._resolve()
        if fam is None:
            return 0, 0
        idx = bisect_left(fam.buckets, self.threshold_s)
        bad = total = 0
        for values, child in fam.collect():
            if self._labels:
                lv = dict(zip(fam.labelnames, values))
                if any(lv.get(self._label_key(fam, k)) != v
                       for k, v in self._labels.items()):
                    continue
            snap = child.snapshot()
            total += snap["count"]
            # buckets: [(bound, cumulative), ..., (inf, count)]
            good = snap["buckets"][idx][1] if idx < len(snap["buckets"]) \
                else snap["count"]
            bad += snap["count"] - good
        return bad, total


class BurnRateMonitor:
    """Evaluate burn rates for a set of SLOs over sliding windows.

    ``evaluate()`` samples each SLO's cumulative (bad, total), differences
    against retained history per window, updates the
    ``mx_slo_burn_rate{slo,window}`` gauges, and fires a rate-limited
    alert when every window burns past ``alert_burn_rate``. ``tick()``
    is the step-loop form (at most one evaluation per ``eval_interval_s``).

    A window with no retained sample old enough is evaluated against the
    oldest available one — a just-started process alerts on sustained
    early burn instead of staying silent for a full hour.
    """

    def __init__(self, slos=(), windows=(300.0, 3600.0),
                 alert_burn_rate=14.4, eval_interval_s=15.0,
                 warn_interval_s=300.0, monitor=None, registry=None,
                 clock=time.monotonic, logger=None):
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("need at least one window")
        self.alert_burn_rate = float(alert_burn_rate)
        self.eval_interval_s = float(eval_interval_s)
        self.warn_interval_s = float(warn_interval_s)
        self._monitor = monitor
        self._clock = clock
        self._logger = logger if logger is not None else \
            _log.get_logger("mxnet_tpu_torch.telemetry")
        reg = registry or _metrics.REGISTRY
        self._burn_gauge = reg.gauge(
            "mx_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = budget "
            "consumed exactly at the sustainable pace)",
            labels=("slo", "window"))
        self._alerts = reg.counter(
            "mx_slo_alerts_total",
            "Multi-window burn-rate alerts fired", labels=("slo",))
        self._anomalies = reg.counter(
            "mx_anomalies_total",
            "Step-health anomalies detected by telemetry.StepMonitor",
            labels=("kind",))
        self._slos = []
        self._history = {}          # slo name -> deque[(t, bad, total)]
        self._last_eval = None
        for slo in slos:
            self.add(slo)

    def add(self, slo):
        """Register a :class:`ServiceLevelObjective`; returns it."""
        if any(s.name == slo.name for s in self._slos):
            raise ValueError("SLO %r already registered" % (slo.name,))
        self._slos.append(slo)
        # Retain just enough history to difference the longest window
        # at this cadence (+2 slack for edge samples).
        depth = int(self.windows[-1] / max(self.eval_interval_s, 1e-9)) + 2
        self._history[slo.name] = deque(maxlen=max(depth, 4))
        # Seed the baseline NOW: an SLO registered mid-run (a gateway
        # model added to a live monitor) must difference its first
        # evaluation against registration time, not wait a full
        # evaluation cycle to start burning.
        bad, total = slo.totals()
        self._history[slo.name].append((self._clock(), bad, total))
        return slo

    def remove(self, name):
        """Unregister an SLO: drop its history AND its emitted
        ``mx_slo_burn_rate``/``mx_slo_alerts_total`` children (the
        serving gateway's model-unregister path — a process cycling
        models must not accumulate dead SLO series in every scrape).
        Unknown names are a no-op."""
        self._slos = [s for s in self._slos if s.name != name]
        self._history.pop(name, None)
        for fam in (self._burn_gauge, self._alerts):
            for values, _ in fam.collect():
                if values[0] == name:   # labelnames lead with "slo"
                    fam.remove(**dict(zip(fam.labelnames, values)))

    def add_latency_slo(self, name, objective, threshold_s, family,
                        labels=None, registry=None):
        """Declare-and-register shorthand."""
        return self.add(ServiceLevelObjective(
            name, objective, threshold_s, family, labels=labels,
            registry=registry))

    # -- evaluation -----------------------------------------------------------

    def _window_burn(self, slo, history, now, window):
        """Burn rate over [now - window, now] from cumulative samples."""
        t, bad, total = history[-1]
        base = None
        for sample in history:
            if sample[0] >= now - window - 1e-9:
                base = sample
                break
        if base is None or base is history[-1]:
            return 0.0
        d_total = total - base[2]
        d_bad = bad - base[1]
        if d_total <= 0 or d_bad <= 0:
            return 0.0
        return (d_bad / d_total) / slo.error_budget

    def evaluate(self, now=None):
        """One evaluation pass; returns
        ``{slo_name: {window_label: burn_rate}}``."""
        now = self._clock() if now is None else float(now)
        self._last_eval = now
        out = {}
        for slo in self._slos:
            history = self._history[slo.name]
            bad, total = slo.totals()
            if history and (bad < history[-1][1]
                            or total < history[-1][2]):
                history.clear()     # counters went backwards: reset
            history.append((now, bad, total))
            burns = {}
            for window in self.windows:
                burn = self._window_burn(slo, history, now, window)
                burns[format_window(window)] = burn
                self._burn_gauge.labels(
                    slo=slo.name, window=format_window(window)).set(burn)
            out[slo.name] = burns
            if burns and min(burns.values()) >= self.alert_burn_rate:
                self._alert(slo, burns, now)
        return out

    def tick(self):
        """Step-loop cadence call: evaluate at most once per
        ``eval_interval_s``."""
        now = self._clock()
        if self._last_eval is not None and \
                now - self._last_eval < self.eval_interval_s:
            return None
        return self.evaluate(now)

    # -- alerting -------------------------------------------------------------

    def _alert(self, slo, burns, now):
        self._alerts.labels(slo=slo.name).inc()
        msg = ("SLO %s burning error budget at %s (objective %.3f%% "
               "under %gs, alert at %.1fx)"
               % (slo.name,
                  ", ".join("%.1fx/%s" % (b, w)
                            for w, b in sorted(burns.items())),
                  slo.objective * 100.0, slo.threshold_s,
                  self.alert_burn_rate))
        if self._monitor is not None:
            self._monitor.record_anomaly("slo_burn", msg)
            return
        self._anomalies.labels(kind="slo_burn").inc()
        _trace.instant("telemetry::anomaly", kind="slo_burn")
        _log.warn_rate_limited(
            self._logger, "slo_burn:%s" % slo.name, self.warn_interval_s,
            "[telemetry:slo_burn] %s", msg, now=now)
