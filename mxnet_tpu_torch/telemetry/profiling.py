"""mxnet_tpu_torch.telemetry.profiling — always-on continuous CPU profiling.

A copy of ``mxnet_tpu/telemetry/profiling.py``, which imports no JAX.

The observability stack so far reconstructs "where did the time go"
from *instrumented spans* — anything outside a span (decode workers
spinning on the GIL, kvstore pickling, ``block_until_ready`` waits,
user callbacks) is invisible, and there is no profile you can pull
from a healthy production pod. This module is the Google-Wide-Profiling
layer: a :class:`ContinuousProfiler` samples every thread's Python
stack (``sys._current_frames()``) at a configurable rate (default
~67 Hz, ``MXNET_PROFILE_HZ``) from a daemon thread, folds the samples
into **collapsed stacks** per fixed window (``MXNET_PROFILE_WINDOW_S``)
and keeps a bounded retention ring of window profiles
(``MXNET_PROFILE_RETAIN``), so the last N minutes of "what was this
process actually doing" are always pullable — from
``GET /debug/pprof`` on the healthplane server, from a flight-recorder
bundle (every bundle gains a ``profile`` section automatically while a
profiler is active), or pod-wide over the kvstore diag channel
(:meth:`~mxnet_tpu_torch.telemetry.healthplane.DiagCollector.request_pod_profile`).

Design points:

* **Collapsed-stack output** reuses the exact format
  :func:`..flamegraph.collapsed` emits (``root;frame;frame <self_us>``
  — each sample's leaf is charged one sample period), so
  ``tools/flame_diff.py``, ``flamegraph.diff_top`` and every standard
  flamegraph tool work on sampler captures unchanged. Frame keys carry
  ``func (file:line)`` (:func:`..flamegraph.frame_label`) so two
  same-named methods — every worker loop is called ``run`` — never
  merge into one frame.
* **Lane tagging.** A sampled thread currently holding a watchdog
  heartbeat lane (``step`` / ``serving#N`` / ``checkpoint#N`` /
  ``data#N`` — the in-flight markers the hot paths already maintain)
  is rooted under that lane name instead of its raw thread name, so a
  profile splits by *component* and "the step thread spends 30% in
  pickle" reads directly off the capture.
* **Self-accounting.** The sampler bills itself:
  ``mx_profile_samples_total`` and ``mx_profile_overhead_seconds``
  (wall time spent capturing+folding) make its overhead a measured
  number, not a promise. The profiler's own thread is excluded from
  captures.
* **Regression sentinel.** Each closed window diffs against a rolling
  (EWMA-decayed) baseline of earlier windows via
  ``flamegraph.diff_top``; a leaf frame whose self-time *share* grew
  past ``regress_pp`` percentage points raises a
  ``profile_regression`` anomaly through the StepMonitor — which a
  subscribed FlightRecorder turns into a diagnostic bundle whose
  ``profile`` section holds the offending capture.

The clock is injectable and sampling/rotation are callable directly
(:meth:`ContinuousProfiler.sample` / :meth:`maybe_rotate`), so every
behavior is deterministic under a fake clock without the thread.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque

from . import flamegraph as _flamegraph
from . import metrics as _metrics
from . import watchdog as _watchdog
from . import xtrace as _xtrace

__all__ = ["ContinuousProfiler", "ProfileWindow", "active_profiler",
           "bundle_state", "merge_collapsed", "prefix_collapsed"]

_samples_total = _metrics.REGISTRY.counter(
    "mx_profile_samples_total",
    "Stack samples captured by the continuous profiler")
_overhead_seconds = _metrics.REGISTRY.counter(
    "mx_profile_overhead_seconds",
    "Wall time the continuous profiler spent capturing+folding samples "
    "(its self-accounted cost)")
_windows_total = _metrics.REGISTRY.counter(
    "mx_profile_windows_total",
    "Profile windows closed into the retention ring")
_hz_gauge = _metrics.REGISTRY.gauge(
    "mx_profile_hz",
    "Continuous profiler's CURRENT sampling rate (adaptive sampling "
    "backs it off when the self-accounted overhead share exceeds its "
    "budget, and restores it as headroom returns)")
_backoffs_total = _metrics.REGISTRY.counter(
    "mx_profile_rate_adjustments_total",
    "Adaptive sampling rate changes", labels=("direction",))

# The active profiler: the flight recorder's `profile` bundle section,
# the healthplane's default /debug/pprof source and DiagCollector
# pod-profile captures all read this. Claimed by a profiler that is
# actually PRODUCING (start/sample/rotate), not merely constructed —
# a built-but-never-started instance must not hijack the live one's
# endpoints with blank captures.
_active = [None]


def active_profiler():
    """The most recently producing (started/sampling, not yet closed)
    ContinuousProfiler, or None."""
    return _active[0]


def bundle_state(seconds=None):
    """The flight-recorder ``profile`` section: the active profiler's
    configuration, counters and a collapsed capture of the last
    ``seconds`` (default: one window). None when no profiler runs —
    the bundle then records the section as absent, not an error."""
    profiler = _active[0]
    if profiler is None:
        return None
    return profiler.debug_state(seconds=seconds)


def merge_collapsed(captures):
    """Fold several collapsed captures (strings or {path: us} dicts)
    into one ``{path: self_us}`` dict — the pod-profile merge and
    ``tools/profile_tool.py merge``."""
    folded = {}
    for capture in captures:
        for path, us in _flamegraph._parse_collapsed(capture).items():
            folded[path] = folded.get(path, 0.0) + us
    return folded


def prefix_collapsed(capture, prefix):
    """Re-root every stack of a collapsed capture under ``prefix``
    (``rank0;step;...``) so merged pod profiles keep one lane per
    rank."""
    folded = _flamegraph._parse_collapsed(capture)
    return _flamegraph.render_collapsed(
        {"%s;%s" % (prefix, path): us for path, us in folded.items()})


class ProfileWindow:
    """One closed sampling window: immutable once in the ring."""

    __slots__ = ("seq", "start_wall", "end_wall", "samples", "folded",
                 "overhead_s")

    def __init__(self, seq, start_wall, end_wall, samples, folded,
                 overhead_s):
        self.seq = seq
        self.start_wall = start_wall
        self.end_wall = end_wall
        self.samples = samples
        self.folded = folded            # {stack_path: self_us}
        self.overhead_s = overhead_s

    def collapsed(self):
        return _flamegraph.render_collapsed(self.folded)

    def to_dict(self):
        return {"seq": self.seq, "start_wall": self.start_wall,
                "end_wall": self.end_wall, "samples": self.samples,
                "overhead_s": round(self.overhead_s, 6),
                "folded": {k: round(v, 1)
                           for k, v in self.folded.items()}}


def _default_hz():
    from .. import env as _env

    return float(_env.get("MXNET_PROFILE_HZ"))


def _default_window_s():
    from .. import env as _env

    return float(_env.get("MXNET_PROFILE_WINDOW_S"))


def _default_retain():
    from .. import env as _env

    return int(_env.get("MXNET_PROFILE_RETAIN"))


class ContinuousProfiler:
    """Always-on stack sampler with windowed collapsed-stack profiles.

    Parameters
    ----------
    hz : sampling rate (default ``MXNET_PROFILE_HZ``, ~67 — a prime-ish
        non-multiple of common loop rates, the GWP discipline against
        lockstep aliasing).
    window_s : profile window length (default ``MXNET_PROFILE_WINDOW_S``,
        30 s). Each window closes into the retention ring.
    retain : windows kept (default ``MXNET_PROFILE_RETAIN``, 20 — ten
        minutes of profile history at the defaults).
    monitor : StepMonitor, optional — the regression sentinel fires
        ``profile_regression`` anomalies through it (rate-limited warn,
        ``mx_anomalies_total``, flight-recorder bundles).
    regress_pp : leaf-frame self-time-share growth (percentage points,
        vs the rolling baseline) that counts as a regression
        (default 10).
    min_samples : windows with fewer samples than this neither feed the
        baseline nor trip the sentinel (a mostly-idle window's shares
        are noise).
    baseline_alpha : EWMA weight of the newest window in the rolling
        baseline.
    clock / wall : injectable monotonic + wall clocks for tests.
    """

    def __init__(self, hz=None, window_s=None, retain=None, monitor=None,
                 regress_pp=10.0, min_samples=10, baseline_alpha=0.3,
                 clock=time.monotonic, wall=time.time,
                 adaptive=True, overhead_budget=0.01, min_hz=2.0,
                 perf=time.perf_counter):
        self.hz = _default_hz() if hz is None else float(hz)
        if self.hz <= 0:
            raise ValueError("hz must be > 0")
        # Adaptive sampling: every closed window compares the sampler's
        # self-accounted overhead share against its budget (the bench
        # contract's <=1%) and halves the rate when over, doubling back
        # toward the configured rate once the share drops well under —
        # a pathological process (thousands of threads, deep stacks)
        # degrades profile resolution instead of stealing step time.
        self.base_hz = self.hz
        self.adaptive = bool(adaptive)
        self.overhead_budget = float(overhead_budget)
        self.min_hz = float(min_hz)
        self._perf = perf
        # Export the live rate from construction (not only after the
        # first adjustment) so dashboards never read a false 0.
        _hz_gauge.set(self.hz)
        self.window_s = _default_window_s() if window_s is None \
            else float(window_s)
        self.retain = _default_retain() if retain is None else int(retain)
        self._monitor = monitor
        self.regress_pp = float(regress_pp)
        self.min_samples = int(min_samples)
        self.baseline_alpha = float(baseline_alpha)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()       # ring + window swap only
        self.windows = deque(maxlen=max(1, self.retain))
        self._seq = 0
        self._folded = {}                   # current window accumulation
        self._samples_in_window = 0
        self._overhead_in_window = 0.0
        self._window_started = clock()
        self._window_started_wall = wall()
        self._baseline = None               # rolling EWMA folded dict
        self._names = {}                    # tid -> thread name cache
        self._stop = threading.Event()
        self._thread = None
        self._own_tid = None

    # -- sampling -------------------------------------------------------------

    def _roots(self):
        """tid -> root label. A thread holding an in-flight watchdog
        lane is rooted by the lane name (component view); everything
        else by its thread name."""
        names = {}
        for thread in threading.enumerate():
            if thread.ident is not None:
                names[thread.ident] = thread.name
        for lane, state in _watchdog.lane_snapshot().items():
            if state["busy_s"] is not None and \
                    state["thread_id"] in names:
                names[state["thread_id"]] = lane
        return names

    def sample(self):
        """Capture one stack sample of every thread (the profiler's own
        excluded) and fold it into the current window. Returns the
        number of threads sampled. Callable directly (tests, manual
        profiling) — the background thread does exactly this."""
        if not self._stop.is_set():     # a closed profiler never
            _active[0] = self           # re-claims the active slot
        t0 = self._perf()
        period_us = 1e6 / self.hz
        roots = self._roots()
        own = self._own_tid if self._own_tid is not None \
            else threading.get_ident()
        frames = sys._current_frames()
        sampled = 0
        folded = self._folded
        for tid, frame in frames.items():
            if tid == own:
                continue
            parts = []
            # A thread holding an active sampled TraceContext gets a
            # ``trace:<id>`` LEAF frame: a hot frame in /debug/pprof
            # then links to concrete traces in the merged timeline.
            ctx = _xtrace.context_of_thread(tid)
            if ctx is not None and ctx.sampled:
                parts.append("trace:%s" % ctx.trace_id)
            while frame is not None:
                code = frame.f_code
                parts.append(_flamegraph.frame_label(
                    code.co_name, code.co_filename, code.co_firstlineno))
                frame = frame.f_back
            parts.append(roots.get(tid, "tid-%d" % tid))
            path = ";".join(reversed(parts))
            folded[path] = folded.get(path, 0.0) + period_us
            sampled += 1
        self._samples_in_window += 1
        dt = self._perf() - t0
        self._overhead_in_window += dt
        _samples_total.inc()
        _overhead_seconds.inc(dt)
        return sampled

    # -- windows --------------------------------------------------------------

    def maybe_rotate(self, now=None):
        """Close the current window once ``window_s`` has elapsed on the
        profiler's clock. Returns the closed :class:`ProfileWindow` or
        None."""
        now = self._clock() if now is None else now
        if now - self._window_started < self.window_s:
            return None
        return self.rotate(now=now)

    def rotate(self, now=None):
        """Close the current window unconditionally into the retention
        ring, run the regression sentinel against the rolling baseline,
        and start a fresh window. Empty windows (zero samples) rotate
        silently — an idle profiler must not grow the ring with
        blanks."""
        now = self._clock() if now is None else now
        if not self._stop.is_set():     # (close()'s final rotate must
            _active[0] = self           # not stomp another profiler)
        with self._lock:
            folded = self._folded
            samples = self._samples_in_window
            overhead = self._overhead_in_window
            window_wall = now - self._window_started
            self._folded = {}
            self._samples_in_window = 0
            self._overhead_in_window = 0.0
            self._window_started = now
            start_wall = self._window_started_wall
            self._window_started_wall = self._wall()
        self._adapt(window_wall, overhead)
        with self._lock:
            if not samples:
                return None
            self._seq += 1
            window = ProfileWindow(self._seq, start_wall, self._wall(),
                                   samples, folded, overhead)
            self.windows.append(window)
        _windows_total.inc()
        self._sentinel(window)
        return window

    def _adapt(self, window_wall, overhead_s):
        """Adaptive sampling: keep the self-accounted overhead share of
        wall time inside ``overhead_budget`` (the ≤1% contract). Over
        budget → halve the rate (floor ``min_hz``); once the share
        falls under a quarter of the budget → double back toward the
        configured ``base_hz``. Hysteresis (x2 down at 1x budget, x2 up
        at 0.25x) keeps the rate from flapping at the boundary."""
        if not self.adaptive or window_wall <= 0:
            return
        share = overhead_s / window_wall
        if share > self.overhead_budget and self.hz > self.min_hz:
            self.hz = max(self.min_hz, self.hz / 2.0)
            _backoffs_total.labels(direction="down").inc()
            _hz_gauge.set(self.hz)
        elif share < self.overhead_budget / 4.0 and self.hz < self.base_hz:
            self.hz = min(self.base_hz, self.hz * 2.0)
            _backoffs_total.labels(direction="up").inc()
            _hz_gauge.set(self.hz)

    def _sentinel(self, window):
        """Rolling-baseline regression check: the newest window's
        leaf-frame self-time shares vs the EWMA of earlier windows."""
        if window.samples < self.min_samples:
            return
        baseline = self._baseline
        if baseline is not None and self._monitor is not None:
            rows = _flamegraph.diff_top(baseline, window.folded, k=1)
            if rows and rows[0]["delta_pp"] >= self.regress_pp:
                worst = rows[0]
                self._monitor.record_anomaly(
                    "profile_regression",
                    "profile regression: %r grew from %.1f%% to %.1f%% "
                    "of self time (+%.1fpp over the rolling baseline; "
                    "window %d, %d samples) — pull /debug/pprof for the "
                    "full capture"
                    % (worst["op"], worst["before_share"] * 100.0,
                       worst["after_share"] * 100.0, worst["delta_pp"],
                       window.seq, window.samples))
        if baseline is None:
            self._baseline = dict(window.folded)
        else:
            # EWMA decay: old frames fade, a regime change re-baselines
            # within a few windows (the StepMonitor EWMA discipline).
            a = self.baseline_alpha
            merged = {k: (1.0 - a) * v for k, v in baseline.items()}
            for k, v in window.folded.items():
                merged[k] = merged.get(k, 0.0) + a * v
            self._baseline = merged

    # -- reading --------------------------------------------------------------

    def _selected(self, seconds=None, include_current=True):
        """Windows covering the last ``seconds`` of wall time (None =
        the newest window only), plus the in-progress window's folded
        state when ``include_current``."""
        with self._lock:
            ring = list(self.windows)
            current = dict(self._folded) if include_current else None
            current_samples = self._samples_in_window
        if seconds is None:
            selected = ring[-1:]
        else:
            horizon = self._wall() - float(seconds)
            selected = [w for w in ring if w.end_wall >= horizon]
        parts = [w.folded for w in selected]
        samples = sum(w.samples for w in selected)
        if current:
            parts.append(current)
            samples += current_samples
        return parts, samples, selected

    def collapsed(self, seconds=None, include_current=True):
        """Collapsed-stack text over the last ``seconds`` of profile
        (merging whole windows; None = the newest window plus the
        in-progress one) — the ``/debug/pprof`` body, diffable with
        ``tools/flame_diff.py`` against any other capture."""
        parts, _, _ = self._selected(seconds, include_current)
        return _flamegraph.render_collapsed(merge_collapsed(parts))

    def dump(self, path, seconds=None):
        """Atomically write :meth:`collapsed` to ``path`` (the
        ``dump_collapsed`` commit protocol); returns the path."""
        from . import export as _export

        _export.commit_bytes(path,
                             self.collapsed(seconds).encode("utf-8"))
        return path

    def debug_state(self, seconds=None):
        """JSON-able view for bundles and ``format=json`` pprof reads:
        config, counters, per-window metadata, the merged collapsed
        capture, and per-frame trace exemplars — the ``trace:<id>``
        markers :meth:`sample` leaves on sampled-context threads,
        attributed to the hot frame they annotated, so a profile frame
        links to concrete traces in the merged timeline."""
        parts, samples, selected = self._selected(seconds)
        with self._lock:
            meta = [{"seq": w.seq, "start_wall": w.start_wall,
                     "end_wall": w.end_wall, "samples": w.samples,
                     "overhead_s": round(w.overhead_s, 6)}
                    for w in self.windows]
        merged = merge_collapsed(parts)
        # The JSON view carries the linkage structurally: the collapsed
        # capture is cleaned of trace:<id> leaves, which reappear under
        # "exemplars" attached to the frame they annotated. (The text
        # endpoints keep the raw markers for merge tooling.)
        merged, by_frame = _flamegraph.trace_exemplars(merged)
        exemplars = {
            frame: [{"trace_id": tid, "self_us": round(us, 1)}
                    for tid, us in sorted(ids.items(),
                                          key=lambda kv: -kv[1])]
            for frame, ids in by_frame.items()}
        return {
            "hz": self.hz, "window_s": self.window_s,
            "retain": self.retain, "windows": meta,
            "captured_samples": samples,
            "selected_windows": [w.seq for w in selected],
            "collapsed": _flamegraph.render_collapsed(merged),
            "exemplars": exemplars,
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        """Sample every ``1/hz`` seconds from a daemon thread (returns
        self)."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                self._own_tid = threading.get_ident()
                # Period re-read every beat: adaptive sampling may have
                # changed self.hz since the last one.
                while not self._stop.wait(1.0 / self.hz):
                    try:
                        self.sample()
                        self.maybe_rotate()
                    except Exception:
                        # One failed capture (thread torn down mid-walk)
                        # is a lost sample, not a dead profiler.
                        pass

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-profiler", daemon=True)
            self._thread.start()
        _active[0] = self
        return self

    def close(self, timeout=5.0):
        """Stop sampling, close the in-progress window into the ring,
        and deactivate."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.rotate()
        if _active[0] is self:
            _active[0] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
