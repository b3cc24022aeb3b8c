"""mxnet_tpu_torch.telemetry.recorder — the flight recorder: anomaly-triggered
diagnostic bundles.

Counterpart of ``mxnet_tpu/telemetry/recorder.py``, copied but for the
bundle's ``env`` section, which names the versions of torch and CUDA
and the card where the JAX package names jax's.

The metrics and the step monitor *count* failures (``mx_anomalies_total``);
this module makes it keep the evidence. The moment an anomaly fires —
a hang, a NaN loss, a recompile storm, a stale rank — the evidence a
human needs is transient: the thread stacks ARE the hang, the in-flight
batch ids ARE the poison batch, the span rings age out in seconds. A
:class:`FlightRecorder` subscribes to ``StepMonitor.record_anomaly``
(the ``on_anomaly`` observer list) and, rate-limited per anomaly kind,
atomically commits a **diagnostic bundle** — one self-contained JSON
file, ``diag.rank<R>.<SEQ>.json``, written through the checkpoint
writer's tmp+fsync+rename seam (:func:`..export.commit_bytes`), so a
kill at any byte leaves either a complete bundle or nothing, never a
torn one.

Bundle contents (the black-box recorder set):

* ``threads`` — every thread's stack (``sys._current_frames`` + thread
  names), captured on the detecting thread at the moment of failure;
* ``spans`` — the last-N trace events still buffered in the rings
  (snapshotted non-destructively, so a concurrent
  ``StreamingTraceWriter`` loses nothing), each carrying ``span_id``
  when span ids are on;
* ``registry`` — a full metric-registry snapshot
  (:func:`..aggregate.snapshot_registry`) plus any recorded exemplars;
* ``anomalies`` — recent anomaly history (what fired, when) and every
  attached monitor's counters/EWMA/step count;
* ``xtrace`` — tail-based trace capture: every trace flagged anomalous
  (:func:`~mxnet_tpu_torch.telemetry.xtrace.flag` — deadline-exceeded
  requests, slow steps, SLO burn) with its full locally-buffered span
  tree, so the offending request/step reconstructs from the bundle
  alone (peer-rank spans ride in via
  :meth:`~mxnet_tpu_torch.telemetry.healthplane.DiagCollector.feed_recorder`);
* ``data`` — each watched pipeline's delivered-batch watermark and the
  ids of the batch in flight (``DataPipeline.debug_state``), so a
  poison batch is replayable;
* ``device_memory`` / ``compile`` — live/peak device bytes and compile
  accounting (:mod:`..memstats`);
* ``watchdog`` — heartbeat-lane states (which lane was in flight, for
  how long, on which thread);
* ``profile`` — the continuous profiler's latest collapsed-stack
  window (when a :class:`~mxnet_tpu_torch.telemetry.profiling.\
ContinuousProfiler` is active): what every thread was *actually* doing
  in the minutes before the anomaly, spans or not;
* ``env`` — knob catalogue values, MXNET_*/DMLC_*/CUDA_*/NCCL_*/TORCH_*
  environ, python, torch and CUDA versions and the card's name, argv,
  uptime.

``tools/diagnose.py`` pretty-prints a bundle and merges per-rank
bundles from one incident. Capture runs inline on the detecting thread
(that is the point — the state must be read before it changes) and is
rate-limited per kind; a commit failure is warned and swallowed, never
raised into the loop.
"""
from __future__ import annotations

import os
import re
import sys
import threading
import time
import traceback
from collections import deque

from . import metrics as _metrics
from . import trace as _trace
from .. import log as _log

__all__ = ["FlightRecorder", "DIAG_FORMAT", "DIAG_RE", "bundle_name",
           "thread_stacks"]

DIAG_FORMAT = "mxnet_tpu.diag_bundle/1"
DIAG_RE = re.compile(r"^diag\.rank(\d+)\.(\d+)\.json$")

_bundles_total = _metrics.REGISTRY.counter(
    "mx_diag_bundles_total",
    "Diagnostic bundles committed by the flight recorder",
    labels=("kind",))
_suppressed_total = _metrics.REGISTRY.counter(
    "mx_diag_suppressed_total",
    "Anomalies that did NOT produce a bundle (per-kind rate limit)",
    labels=("kind",))


def bundle_name(rank, seq):
    return "diag.rank%d.%06d.json" % (rank, seq)


def thread_stacks():
    """Structured stacks of every live thread, innermost frame last."""
    frames = sys._current_frames()
    meta = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        thread = meta.get(tid)
        stack = [{"file": f.filename, "line": f.lineno, "func": f.name,
                  "code": f.line}
                 for f in traceback.extract_stack(frame)]
        out.append({"thread_id": tid,
                    "name": thread.name if thread else "tid-%d" % tid,
                    "daemon": thread.daemon if thread else None,
                    "stack": stack})
    out.sort(key=lambda t: t["name"])
    return out


class FlightRecorder:
    """Anomaly-triggered post-mortem bundle writer.

    Parameters
    ----------
    directory : bundle directory (created if missing; shared across
        ranks — the rank is encoded in every bundle name).
    rank : lane id for this process (default
        :func:`..export.default_rank`).
    rate_limit_s : per-KIND floor between bundles (default 60 s).
        Anomalies inside the window are counted
        (``mx_diag_suppressed_total``) and folded into the next
        bundle's ``suppressed_since_last``.
    fail_backoff_s : floor between capture ATTEMPTS after a failed
        commit (default 5 s, all kinds). A dead disk must not charge
        every anomaly the full collection cost (stacks + registry +
        span tail) inline on the detecting thread — but the window is
        short so evidence flows again moments after storage recovers
        (the per-kind limiter only arms on a COMMITTED bundle).
    last_spans : how many trailing trace events a bundle carries.
    history : length of the rolling anomaly-history ring.
    registry : metric registry to snapshot (default the process-wide
        one).
    clock : injectable monotonic clock for the rate limiter.

    Wiring::

        recorder = FlightRecorder("diag/")
        recorder.attach(monitor)          # bundles on every anomaly
        recorder.watch_pipeline(pipe)     # batch-id provenance
        recorder.add_source("lr", lambda: trainer.learning_rate)
    """

    def __init__(self, directory, rank=None, rate_limit_s=60.0,
                 fail_backoff_s=5.0, last_spans=256, history=64,
                 registry=None, clock=time.monotonic):
        from . import export as _export

        self.directory = directory
        self.rank = _export.default_rank() if rank is None else int(rank)
        self.rate_limit_s = float(rate_limit_s)
        self.fail_backoff_s = float(fail_backoff_s)
        self.last_spans = int(last_spans)
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._history = deque(maxlen=int(history))
        self._last_fire = {}        # kind -> clock()
        self._backoff_until = None  # clock(); set by a failed commit
        self._suppressed = {}       # kind -> count since last bundle
        self._monitors = []
        self._pipelines = []
        self._extra = {}
        self._started_wall = time.time()
        self._started = clock()
        self.bundles = []           # committed bundle paths
        os.makedirs(directory, exist_ok=True)
        # Resume-safe sequencing (the StreamingTraceWriter discipline):
        # a restarted process extends the bundle set, never overwrites.
        self._seq = 1 + max(
            (int(m.group(2)) for m in map(DIAG_RE.match,
                                          os.listdir(directory))
             if m and int(m.group(1)) == self.rank), default=0)

    # -- wiring ---------------------------------------------------------------

    def attach(self, monitor):
        """Subscribe to a StepMonitor's anomaly stream (its
        ``record_anomaly`` path, built-in detectors included). Returns
        the monitor so ``recorder.attach(StepMonitor())`` composes."""
        monitor.on_anomaly.append(self._on_anomaly)
        self._monitors.append(monitor)
        return monitor

    def watch_pipeline(self, pipeline):
        """Include a DataPipeline's watermark + in-flight batch ids in
        every bundle. Returns the pipeline."""
        self._pipelines.append(pipeline)
        return pipeline

    def add_source(self, name, fn):
        """Register an extra bundle section: ``fn()`` is called at
        capture time, its (JSON-able) result lands under
        ``extra[name]``; a failing source records its error string
        instead of spoiling the bundle."""
        self._extra[str(name)] = fn
        return self

    # -- trigger path ---------------------------------------------------------

    def _on_anomaly(self, kind, msg):
        """StepMonitor observer: record history, rate-limit per kind,
        capture. Runs inline on the detecting thread — the stacks and
        batch ids must be read before they change. The rate limiter
        arms only on a COMMITTED bundle: a transient commit failure
        (disk full, NFS blip) must not suppress the kind for a whole
        window with zero evidence on disk."""
        self._history.append({"wall_time": time.time(), "kind": kind,
                              "msg": msg})
        with self._lock:
            now = self._clock()
            last = self._last_fire.get(kind)
            limited = (last is not None and
                       now - last < self.rate_limit_s)
            backing_off = (self._backoff_until is not None and
                           now < self._backoff_until)
            if limited or backing_off:
                self._suppressed[kind] = \
                    self._suppressed.get(kind, 0) + 1
                _suppressed_total.labels(kind=kind).inc()
                return None
        path = self.capture(kind, msg)
        if path is not None:
            with self._lock:
                self._last_fire[kind] = now
        return path

    def request(self, kind, msg=""):
        """Rate-limited capture request — the same per-kind limiter +
        history path an anomaly trigger takes, for external requesters
        (the pod-snapshot fan-out in
        :class:`~mxnet_tpu_torch.telemetry.healthplane.DiagCollector`): a
        snapshot storm from a flapping operator produces a bounded
        bundle stream, with suppressed requests counted onto the next
        bundle. Returns the committed path, or None when suppressed or
        the commit failed."""
        return self._on_anomaly(kind, msg)

    def capture(self, kind="manual", msg=""):
        """Collect and atomically commit one bundle NOW (no rate
        limit). Returns the committed path, or None on commit failure
        (warned, never raised — the staging file is cleaned up; the
        reserved sequence number stays a gap). The recorder's lock
        guards only the small shared state (sequence, rate limiter):
        serialization and the filesystem commit run OUTSIDE it, so a
        capture hung on dead storage cannot wedge another thread's
        anomaly path behind the lock."""
        import json

        from . import export as _export

        bundle = self._collect(kind, msg)
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
        path = os.path.join(self.directory, bundle_name(self.rank, seq))
        bundle["meta"]["seq"] = seq
        try:
            _export.commit_bytes(
                path, json.dumps(bundle, default=str).encode("utf-8"))
        except Exception as exc:
            with self._lock:
                self._backoff_until = self._clock() + self.fail_backoff_s
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "recorder:%d" % id(self), 30.0,
                "diagnostic bundle commit failed: %s", exc)
            return None
        with self._lock:
            self._backoff_until = None
            self._suppressed = {}
            self.bundles.append(path)
        _bundles_total.labels(kind=kind).inc()
        return path

    # -- collection -----------------------------------------------------------

    def _safe(self, section, fn):
        try:
            return fn()
        except Exception as exc:
            return {"error": "%s: %r" % (section, exc)}

    def _collect(self, kind, msg):
        from . import aggregate as _aggregate

        now_wall = time.time()
        bundle = {
            "meta": {
                "format": DIAG_FORMAT,
                "kind": kind,
                "msg": msg,
                "rank": self.rank,
                "pid": os.getpid(),
                "wall_time": now_wall,
                "uptime_s": self._clock() - self._started,
                "recorder_started": self._started_wall,
                "suppressed_since_last": dict(self._suppressed),
            },
            "threads": self._safe("threads", thread_stacks),
            "spans": self._safe("spans", self._span_tail),
            "registry": self._safe(
                "registry",
                lambda: _aggregate.snapshot_registry(self._registry)),
            "exemplars": self._safe(
                "exemplars",
                lambda: _metrics.collect_exemplars(self._registry)
                if _metrics.exemplars_enabled() else []),
            "anomalies": {
                "history": list(self._history),
                "monitors": [self._safe("monitor", m.snapshot)
                             for m in self._monitors],
            },
            "data": [self._safe("pipeline", self._pipeline_state(p))
                     for p in self._pipelines],
            "xtrace": self._safe("xtrace", self._xtrace_state),
            "watchdog": self._safe("watchdog", self._watchdog_state),
            "profile": self._safe("profile", self._profile_state),
            "device_memory": self._safe("device_memory",
                                        self._memory_state),
            "goodput": self._safe("goodput", self._goodput_state),
            "compile": self._safe("compile", self._compile_state),
            "env": self._safe("env", self._env_state),
        }
        if self._extra:
            bundle["extra"] = {name: self._safe(name, fn)
                               for name, fn in self._extra.items()}
        return bundle

    def _xtrace_state(self):
        """Tail-based capture: the span tree of every trace flagged
        anomalous (deadline-exceeded, slow_step, SLO burn) —
        ``flagged`` entries plus each trace's locally buffered spans,
        and whatever peer-rank spans a DiagCollector has already
        collected for it (``feed_recorder`` wires that in via
        ``extra``; peers answer asynchronously over the diag
        channel)."""
        from . import xtrace as _xtrace

        flags = _xtrace.flagged()
        spans = {}
        for entry in flags:
            tid = entry["trace_id"]
            if tid not in spans:
                spans[tid] = _xtrace.collect_spans(tid)
        return {"flagged": flags, "spans": spans}

    def _span_tail(self):
        """Last-N buffered trace events, oldest first — snapshotted
        (not drained), so streaming export still commits them."""
        events = [e for e in _trace.chrome_trace()["traceEvents"]
                  if e.get("ph") != "M"]
        events.sort(key=lambda e: e.get("ts", 0))
        return events[-self.last_spans:]

    @staticmethod
    def _pipeline_state(pipeline):
        def read():
            debug = getattr(pipeline, "debug_state", None)
            return debug() if callable(debug) else pipeline.state_dict()
        return read

    @staticmethod
    def _watchdog_state():
        from . import watchdog as _watchdog

        return _watchdog.lane_snapshot()

    @staticmethod
    def _profile_state():
        from . import profiling as _profiling

        return _profiling.bundle_state()

    @staticmethod
    def _memory_state():
        from . import memstats as _memstats

        return _memstats.sample_device_memory()

    @staticmethod
    def _compile_state():
        from . import memstats as _memstats

        return _memstats.compile_stats()

    @staticmethod
    def _goodput_state():
        """The active goodput ledger's snapshot — bundles carry the
        same numbers ``/debug/goodput`` and the durable ledger file
        render. None when no ledger is installed."""
        from . import goodput as _goodput

        ledger = _goodput.active_ledger()
        return None if ledger is None else ledger.snapshot()

    def _env_state(self):
        import platform

        import torch

        from .. import env as _env

        knobs = {}
        for knob in _env.CATALOGUE:
            try:
                knobs[knob.name] = _env.get(knob.name)
            except Exception:
                knobs[knob.name] = os.environ.get(knob.name)
        selected = {k: v for k, v in os.environ.items()
                    if k.startswith(("MXNET_", "DMLC_", "CUDA_", "NCCL_",
                                     "TORCH_"))}
        out = {"knobs": knobs, "environ": selected,
               "python": sys.version.split()[0],
               "platform": platform.platform(),
               "argv": list(sys.argv),
               "torch": torch.__version__, "cuda": torch.version.cuda}
        # Name the card only where this process already uses CUDA: a
        # bundle must not initialise it (a kvstore server never does).
        if torch.cuda.is_initialized():
            out["device"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
        return out
