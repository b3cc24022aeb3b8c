"""mxnet_tpu_torch.telemetry.watchdog — hang detection with forensic dumps.

A copy of ``mxnet_tpu/telemetry/watchdog.py``, which imports no JAX.
The port's data pipeline heartbeats the ``data`` lanes; the step,
serving and checkpoint lanes, ``StepMonitor`` and ``FlightRecorder``
come with ROADMAP Queue 1 items 5 and 9 (until then a hang fires as a
rate-limited warning, the path without a monitor or recorder).

A hang is the anomaly the step-health monitor cannot see: StepMonitor
only runs when a step COMPLETES, so a step (or serving batch, or
checkpoint commit) that never finishes produces silence, not a warning.
This module closes that gap with the classic watchdog split:

* **Heartbeat lanes** (module level, lock-free). The instrumented hot
  paths mark work in flight: :func:`begin`/:func:`end` around
  ``TrainStep.__call__`` (lane ``"step"``), each InferenceServer's
  batch execution (lane ``"serving"``, instance-suffixed ``serving#2``
  onward — see :func:`unique_lane`) and each CheckpointManager
  writer's commit (lane ``"checkpoint"``, likewise). The calls are a
  dict lookup plus a
  few attribute stores — safe from any thread, cheap enough for the
  ≤1% ``watchdog_idle_overhead_pct`` bench contract, and deliberately
  lock-free so even a signal-interrupted frame cannot deadlock them.
  Each completion feeds a per-lane duration EWMA.

* **The watchdog** (:class:`HangWatchdog`). A daemon thread (or manual
  ``check()`` calls) scans the lanes: work in flight longer than
  ``max(min_deadline_s, factor × EWMA)`` fires a hang anomaly —
  ``step_hang`` / ``serving_hang`` / ``checkpoint_hang`` — through
  ``StepMonitor.record_anomaly``, which a subscribed
  :class:`~telemetry.recorder.FlightRecorder` turns into a
  diagnostic bundle carrying every thread's stack at the moment of the
  hang (the stuck thread included: its id is in the fire message). The
  EWMA term adapts the deadline to the workload — a 50 ms step hangs at
  seconds, a 10-minute checkpoint commit does not false-positive —
  while ``min_deadline_s`` floors it through warmup. A lane refires
  only after a further full deadline, so a persistent hang produces a
  bounded bundle stream, not a storm.

An idle lane (nothing in flight) never fires: a paused training loop or
a serving process with no traffic is silence, not a hang.
"""
from __future__ import annotations

import threading
import time

from . import metrics as _metrics
from .. import log as _log

__all__ = ["HangWatchdog", "begin", "end", "unique_lane",
           "lane_snapshot", "reset", "DEFAULT_KINDS"]

# Anomaly kind per instrumented lane; unknown lanes fire "<name>_hang".
DEFAULT_KINDS = {"step": "step_hang", "serving": "serving_hang",
                 "checkpoint": "checkpoint_hang", "data": "data_hang"}

_fired_total = _metrics.REGISTRY.counter(
    "mx_watchdog_fired_total",
    "Hang-watchdog firings (in-flight work past its deadline)",
    labels=("lane",))


class _Lane:
    """One heartbeat lane. Mutated lock-free from the instrumented hot
    path (GIL-atomic attribute stores); the watchdog thread reads an
    approximate-but-consistent-enough view."""

    __slots__ = ("name", "busy_since", "thread_id", "ewma", "begun",
                 "completed")

    def __init__(self, name):
        self.name = name
        self.busy_since = None      # monotonic seconds, None = idle
        self.thread_id = None
        self.ewma = None            # EWMA of completed durations
        self.begun = 0
        self.completed = 0


_lanes = {}     # name -> _Lane; plain dict, GIL-atomic get/set
_claim_lock = threading.Lock()      # serializes unique_lane claims only


def _lane(name):
    lane = _lanes.get(name)
    if lane is None:
        # Racing first-begins can build two _Lane objects; last store
        # wins and the loser's single beat is lost — harmless, and the
        # price of a lock-free (signal-safe) hot path.
        lane = _lanes[name] = _Lane(name)
    return lane


def unique_lane(base):
    """Claim a lane name not yet in use: ``base`` first, then
    ``base#2``, ``base#3``, ... A lane is a single slot — one logical
    pipeline — so instruments that can be instantiated several times
    per process (InferenceServers, CheckpointManagers) must each claim
    their own lane at construction: sharing one name would let
    instance B's completion clear instance A's in-flight marker and
    silently mask A's hang. Deadline/kind overrides and the anomaly
    kind resolve by the ``base`` prefix (``serving#2`` still fires
    ``serving_hang``). Claims are serialized by a module lock — decode
    workers and the prefetch thread claim ``data`` lanes concurrently
    at runtime, not just at construction."""
    with _claim_lock:
        if base not in _lanes:
            _lane(base)
            return base
        n = 2
        while "%s#%d" % (base, n) in _lanes:
            n += 1
        name = "%s#%d" % (base, n)
        _lane(name)
        return name


def begin(name):
    """Mark lane work in flight (a step/batch/commit started). Called
    from the instrumented hot paths; lock-free and sub-µs."""
    lane = _lane(name)
    lane.thread_id = threading.get_ident()
    lane.begun += 1
    lane.busy_since = time.monotonic()


def end(name):
    """Mark the in-flight work complete; feeds the lane's duration
    EWMA."""
    lane = _lanes.get(name)
    if lane is None:
        return
    t0 = lane.busy_since
    lane.busy_since = None
    if t0 is not None:
        dur = time.monotonic() - t0
        ewma = lane.ewma
        lane.ewma = dur if ewma is None else 0.7 * ewma + 0.3 * dur
    lane.completed += 1


def lane_snapshot():
    """Plain dict view of every lane (recorder bundles, tests)."""
    now = time.monotonic()
    out = {}
    for name, lane in list(_lanes.items()):
        t0 = lane.busy_since
        out[name] = {
            "busy_s": None if t0 is None else now - t0,
            "thread_id": lane.thread_id,
            "ewma_s": lane.ewma,
            "begun": lane.begun,
            "completed": lane.completed,
        }
    return out


def reset(name=None):
    """Drop one lane (or all) — test isolation; the instrumented paths
    recreate lanes on their next begin()."""
    if name is None:
        _lanes.clear()
    else:
        _lanes.pop(name, None)


class HangWatchdog:
    """Scan the heartbeat lanes and turn hangs into anomalies.

    Parameters
    ----------
    monitor : StepMonitor, optional — hangs fire through its
        ``record_anomaly`` (counted, warned, and — with a FlightRecorder
        attached — bundled). Preferred wiring.
    recorder : FlightRecorder, optional — direct capture when no
        monitor is in play (pass one OR the other; with both, the
        monitor path wins and the recorder should be attached to it).
    poll_s : scan cadence of the background thread.
    min_deadline_s : deadline floor (covers warmup, before any EWMA).
    factor : deadline multiple of the lane's completed-duration EWMA.
    ``watch(name, ...)`` overrides floor/factor/kind per lane.
    """

    def __init__(self, monitor=None, recorder=None, poll_s=1.0,
                 min_deadline_s=60.0, factor=10.0):
        self._monitor = monitor
        self._recorder = recorder
        self.poll_s = float(poll_s)
        self.min_deadline_s = float(min_deadline_s)
        self.factor = float(factor)
        self._overrides = {}    # lane -> (min_deadline_s, factor, kind)
        # Refire bookkeeping is PER INSTANCE (lane -> (begun_count,
        # fired_at)): the lanes are shared module state, and a fire
        # recorded on the lane itself would let one watchdog's firing
        # suppress detection in every other instance watching it.
        self._fired_state = {}
        self._stop = threading.Event()
        self._thread = None
        self.fired = []         # (lane, kind, waited_s) history

    def watch(self, name, min_deadline_s=None, factor=None, kind=None):
        """Ensure ``name`` exists as a lane and set per-lane overrides
        (returns self, so configuration chains)."""
        _lane(name)
        self._overrides[name] = (min_deadline_s, factor, kind)
        return self

    def _params(self, name):
        # Instance lanes ("serving#2") inherit overrides and the
        # anomaly kind from their base lane.
        base = name.split("#", 1)[0]
        mind, fac, kind = self._overrides.get(
            name, self._overrides.get(base, (None, None, None)))
        return (self.min_deadline_s if mind is None else float(mind),
                self.factor if fac is None else float(fac),
                kind or DEFAULT_KINDS.get(base, "%s_hang" % base))

    def deadline_for(self, name):
        """The currently effective deadline for a lane (None if the
        lane does not exist yet)."""
        lane = _lanes.get(name)
        if lane is None:
            return None
        mind, fac, _ = self._params(name)
        ewma = lane.ewma
        return mind if ewma is None else max(mind, fac * ewma)

    def check(self, now=None):
        """One scan over every lane; fires hang anomalies for in-flight
        work past its deadline. Returns the lane names fired — callable
        directly for deterministic tests (no thread needed)."""
        now = time.monotonic() if now is None else now
        fired = []
        for lane in list(_lanes.values()):
            t0 = lane.busy_since
            if t0 is None:
                continue
            mind, fac, kind = self._params(lane.name)
            ewma = lane.ewma
            deadline = mind if ewma is None else max(mind, fac * ewma)
            waited = now - t0
            if waited < deadline:
                continue
            previous = self._fired_state.get(lane.name)
            if previous is not None and previous[0] == lane.begun and \
                    now - previous[1] < deadline:
                continue    # refire only after a further full deadline
            # A new begin (begun counter moved) is a new busy period:
            # it fires fresh regardless of the old fire time.
            self._fired_state[lane.name] = (lane.begun, now)
            self._fire(lane, kind, waited, deadline)
            fired.append(lane.name)
        return fired

    def _fire(self, lane, kind, waited, deadline):
        _fired_total.labels(lane=lane.name).inc()
        names = {t.ident: t.name for t in threading.enumerate()}
        msg = ("%s lane hung: in-flight work stuck for %.1fs "
               "(deadline %.1fs%s) on thread %r (ident %s)" % (
                   lane.name, waited, deadline,
                   "" if lane.ewma is None
                   else ", ewma %.3fs" % lane.ewma,
                   names.get(lane.thread_id, "?"), lane.thread_id))
        self.fired.append((lane.name, kind, waited))
        if self._monitor is not None:
            self._monitor.record_anomaly(kind, msg)
        elif self._recorder is not None:
            self._recorder.capture(kind, msg)
        else:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "watchdog:%s" % lane.name, 30.0, "[telemetry:%s] %s",
                kind, msg)

    def start(self):
        """Run :meth:`check` every ``poll_s`` on a daemon thread
        (returns self)."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.poll_s):
                    try:
                        self.check()
                    except Exception as exc:   # never die silently
                        _log.warn_rate_limited(
                            _log.get_logger("mxnet_tpu_torch.telemetry"),
                            "watchdog:scan:%d" % id(self), 30.0,
                            "watchdog scan failed (will retry): %s", exc)

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-watchdog", daemon=True)
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
