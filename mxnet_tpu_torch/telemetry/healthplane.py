"""mxnet_tpu_torch.telemetry.healthplane — the fleet health plane: live
health/readiness/debug endpoints and pod-wide forensics collection.

Counterpart of ``mxnet_tpu/telemetry/healthplane.py``, copied but for
``POST /debug/xprof``, which captures over ``torch.profiler`` where the
JAX package runs ``jax.profiler.trace``. The JAX package writes an
XPlane directory per capture; the port writes one chrome-trace JSON,
``<capture dir>/trace.json`` (:data:`XPROF_TRACE`), with CUDA kernel
events in a process that uses the card (the CUDA activity records every
kernel of the process, whichever thread launched it) and CPU operator
events of the capturing thread. Only one torch.profiler session runs in
a process at a time, so a capture answers 409 while another runs (the
port's ``profiler.set_state('run')`` included).

The module holds three pieces:

* **Readiness registry** (module level, the watchdog-lane discipline).
  Long-lived components claim a slot (:func:`unique_component`) and
  flip it with :func:`set_ready`: ``TrainStep`` after its first step,
  a ``DataPipeline`` once its first batch is delivered. ``/readyz``
  answers 200 only when every registered component is ready — the
  Borg/Kubernetes readiness-gate shape, so a load balancer never routes
  to a rank that is still warming up.

* **:class:`HealthPlane`** — the request handler behind the endpoints
  ``start_http_server(..., health=plane)`` mounts next to ``/metrics``
  on the SAME :class:`~.metrics.MetricsServer`:

  ===========================  =============================================
  ``GET /healthz``             liveness: 200 unless a watchdog lane has
                               in-flight work past its deadline (a hung
                               step/serving batch/decode pool = not alive)
  ``GET /readyz``              readiness: 200 when every registered
                               component reports ready
  ``GET /debug/stacks``        every thread's current stack (JSON)
  ``GET /debug/watchdog``      lane states + effective deadlines
  ``GET /debug/pipeline``      watched DataPipelines' ``debug_state()``
  ``GET /debug/memory``        device memory + compile accounting
  ``GET /debug/pprof``         the continuous profiler's collapsed-stack
                               capture (``?seconds=N`` merges windows,
                               ``&format=collapsed|json``; text/plain by
                               default — pipe straight into flamegraph.pl)
  ``GET /debug/attribution``   step-phase decomposition and bound cause
  ``GET /debug/goodput``       the goodput ledger: per-category
                               goodput/badput seconds, closure check,
                               restart-replay accounting
  ``POST /debug/bundle``       trigger a local flight-recorder bundle NOW
  ``POST /debug/xprof``        capture ``?seconds=N`` of torch.profiler
                               trace into a bundle-linked directory (409
                               while another profiler session runs; 501 +
                               counted failure where the capture errors)
  ===========================  =============================================

  Everything is a JSON view over state the forensics layer already
  maintains — the endpoints add no new bookkeeping to any hot path.

* **:class:`DiagCollector`** — pod-wide forensics over the kvstore
  command channel (the ``telemetry_push`` precedent): each rank's
  committed flight-recorder bundles are ``diag_push``-ed to server 0 and
  pulled by rank 0 into one collected directory
  (``<dir>/rank<R>/diag.rank<R>.<seq>.json`` — the layout
  ``tools/diagnose.py`` expands), so no shared filesystem is needed.
  Rank 0's :meth:`DiagCollector.request_pod_bundle` fans out an
  on-demand capture: every rank's next ``tick()`` sees the request and
  commits a bundle through the recorder's rate limiter — a live "pod
  snapshot" for debugging a job that has not crashed yet.
"""
from __future__ import annotations

import os
import threading
import time

from . import metrics as _metrics
from . import watchdog as _watchdog
from .. import env as _env
from .. import log as _log

__all__ = ["HealthPlane", "DiagCollector", "unique_component",
           "set_ready", "clear_ready", "readiness", "is_ready", "reset",
           "XPROF_TRACE"]

XPROF_TRACE = "trace.json"      # the file a /debug/xprof capture writes


# -- readiness registry (module level, mirrors watchdog's lanes) --------------

_components = {}                # name -> bool (ready?)
_components_lock = threading.Lock()

_ready_gauge = _metrics.REGISTRY.gauge(
    "mx_component_ready",
    "1 when a registered component reports ready (warmup done), else 0",
    labels=("component",))


def unique_component(base):
    """Claim a readiness slot not yet in use: ``base`` first, then
    ``base#2``, ... (the watchdog ``unique_lane`` discipline — each
    TrainStep/InferenceServer/DataPipeline instance owns its own slot,
    so instance B's readiness can never mask instance A's warmup).
    The new slot starts NOT ready."""
    with _components_lock:
        name = base
        n = 2
        while name in _components:
            name = "%s#%d" % (base, n)
            n += 1
        _components[name] = False
    _ready_gauge.labels(component=name).set(0)
    return name


def set_ready(name, ok=True):
    """Flip a component's readiness (registers the slot if needed)."""
    with _components_lock:
        _components[name] = bool(ok)
    _ready_gauge.labels(component=name).set(int(bool(ok)))


def clear_ready(name):
    """Drop a component slot (shutdown path) — a cycled server must not
    leave a permanently not-ready ghost behind."""
    with _components_lock:
        _components.pop(name, None)
    _ready_gauge.remove(component=name)


def readiness():
    """Plain ``{component: ready}`` view."""
    with _components_lock:
        return dict(_components)


def is_ready():
    """True when every registered component is ready (vacuously true
    with none registered — a process with nothing warming up has
    nothing to wait for)."""
    with _components_lock:
        return all(_components.values())


def reset():
    """Drop every component slot (test isolation)."""
    with _components_lock:
        names = list(_components)
        _components.clear()
    for name in names:
        _ready_gauge.remove(component=name)


# -- the endpoint handler ------------------------------------------------------

_xprof_failures = _metrics.REGISTRY.counter(
    "mx_xprof_failures_total",
    "POST /debug/xprof captures that failed (the torch.profiler "
    "session or its export errored)")


class HealthPlane:
    """JSON views over the forensics layer, mountable on a
    :class:`~.metrics.MetricsServer` via
    ``start_http_server(..., health=plane)``.

    Parameters
    ----------
    watchdog : HangWatchdog, optional — supplies the per-lane deadline
        policy ``/healthz`` evaluates (pass the instance already
        scanning the process so probe and anomaly agree). Without one, a
        private non-started HangWatchdog with default deadlines is used
        purely for deadline arithmetic.
    recorder : FlightRecorder, optional — backs ``POST /debug/bundle``
        (404 without one).
    pipelines : DataPipelines whose ``debug_state()`` feeds
        ``/debug/pipeline`` (``watch_pipeline`` adds more).
    profiler : ContinuousProfiler, optional — backs ``/debug/pprof``
        (default: the process's active profiler; 404 when none runs).
    attribution : StepAttribution, optional — backs
        ``/debug/attribution`` (404 without one).
    goodput : GoodputLedger, optional — backs ``/debug/goodput``
        (default: the process's active ledger; 404 when neither
        exists).
    xprof_dir : capture root for ``POST /debug/xprof`` (default: the
        ``MXNET_XPROF_DIR`` knob, else ``<recorder.directory>/xprof``
        so captures land next to the bundles that reference them).
    """

    def __init__(self, watchdog=None, recorder=None, pipelines=(),
                 profiler=None, attribution=None, goodput=None,
                 xprof_dir=None):
        self._watchdog = watchdog if watchdog is not None \
            else _watchdog.HangWatchdog()
        self._recorder = recorder
        self._pipelines = list(pipelines)
        self._profiler = profiler
        self._attribution = attribution
        self._goodput = goodput
        self._xprof_dir = xprof_dir
        self._xprof_lock = threading.Lock()
        self._xprof_seq = 0

    def watch_pipeline(self, pipeline):
        """Include a pipeline's ``debug_state()`` in ``/debug/pipeline``
        (returns the pipeline)."""
        self._pipelines.append(pipeline)
        return pipeline

    # -- probe bodies ---------------------------------------------------------

    def healthz(self):
        """Liveness: ``(healthy, body)``. Unhealthy exactly when a
        watchdog lane's in-flight work is past its effective deadline —
        the same arithmetic that fires ``*_hang`` anomalies, so the
        probe flips within one deadline of a hang and recovers the
        moment the lane completes. Idle lanes never count."""
        lanes = {}
        healthy = True
        for name, state in _watchdog.lane_snapshot().items():
            deadline = self._watchdog.deadline_for(name)
            overdue = (state["busy_s"] is not None and deadline is not None
                       and state["busy_s"] >= deadline)
            lanes[name] = dict(state, deadline_s=deadline,
                               overdue=overdue)
            if overdue:
                healthy = False
        return healthy, {"healthy": healthy, "lanes": lanes}

    def readyz(self):
        """Readiness: ``(ready, body)`` over the component registry."""
        components = readiness()
        ready = all(components.values())
        return ready, {"ready": ready, "components": components}

    # -- debug views ----------------------------------------------------------

    def stacks(self):
        from . import recorder as _recorder

        return {"threads": _recorder.thread_stacks()}

    def pipeline_state(self):
        out = []
        for pipe in self._pipelines:
            try:
                out.append(pipe.debug_state())
            except Exception as exc:
                out.append({"error": repr(exc)})
        return {"pipelines": out}

    def memory(self):
        from . import memstats as _memstats

        try:
            mem = _memstats.sample_device_memory(update_gauges=False)
        except Exception as exc:
            mem = {"error": repr(exc)}
        return {"device_memory": mem,
                "compile": _memstats.compile_stats()}

    def trigger_bundle(self, kind="manual_http", msg="POST /debug/bundle"):
        """Capture one local bundle NOW (no rate limit — this is the
        operator asking). Returns the committed path or None."""
        if self._recorder is None:
            return None
        return self._recorder.capture(kind, msg)

    def pprof(self, seconds=None, format="collapsed"):
        """The ``/debug/pprof`` body: ``(status, body, content_type)``.
        ``format="collapsed"`` (default) returns the folded-stack text
        every flamegraph tool eats; ``"json"`` the profiler's
        ``debug_state`` (window metadata + capture)."""
        from . import profiling as _profiling

        profiler = self._profiler if self._profiler is not None \
            else _profiling.active_profiler()
        if profiler is None:
            return 404, {"error": "no ContinuousProfiler running "
                                  "(start telemetry.ContinuousProfiler)"}
        if format == "json":
            return 200, profiler.debug_state(seconds=seconds)
        return (200, profiler.collapsed(seconds=seconds),
                "text/plain; charset=utf-8")

    def attribution_state(self):
        if self._attribution is None:
            return 404, {"error": "no StepAttribution attached"}
        return 200, self._attribution.snapshot()

    def goodput_state(self):
        """``/debug/goodput`` body: the attached ledger's snapshot
        (default: the process's active ledger — the same state the
        durable file and bundle sections render)."""
        from . import goodput as _goodput

        ledger = self._goodput if self._goodput is not None \
            else _goodput.active_ledger()
        if ledger is None:
            return 404, {"error": "no GoodputLedger attached "
                                  "(construct one and goodput.install "
                                  "it)"}
        return 200, ledger.snapshot()

    def xprof(self, seconds=1.0):
        """``POST /debug/xprof`` body: capture ``seconds`` of
        ``torch.profiler`` trace into a fresh subdirectory of the
        capture root, as one chrome-trace file, :data:`XPROF_TRACE`.
        Returns ``(status, body)`` — 200 with the capture directory,
        404 when no root is resolvable, 409 while another capture or
        torch.profiler session runs in the process, 501 (counted on
        ``mx_xprof_failures_total``) where the capture errors — the
        health plane degrades, it does not crash."""
        from .. import profiler as _profiler

        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return 400, {"error": "seconds must be a number"}
        seconds = min(60.0, max(0.05, seconds))
        base = self._xprof_dir
        if base is None:
            base = _env.get("MXNET_XPROF_DIR", "") or None
        if base is None and self._recorder is not None:
            base = os.path.join(self._recorder.directory, "xprof")
        if base is None:
            return 404, {"error": "no capture directory (pass "
                                  "xprof_dir=, set MXNET_XPROF_DIR, or "
                                  "attach a FlightRecorder)"}
        if not self._xprof_lock.acquire(blocking=False):
            return 409, {"error": "an xprof capture is already running"}
        try:
            session = _profiler.open_session()
            if session is None:
                return 409, {"error": "another torch.profiler session "
                                      "is running in this process"}
            self._xprof_seq += 1
            out_dir = os.path.join(base,
                                   "xprof.%06d" % self._xprof_seq)
            try:
                with session:
                    time.sleep(seconds)
                _profiler.export_trace(
                    session, os.path.join(out_dir, XPROF_TRACE))
            except Exception as exc:
                _xprof_failures.inc()
                return 501, {"error": "profiler capture failed: "
                                      "%r" % exc}
            return 200, {"dir": out_dir, "seconds": seconds}
        finally:
            self._xprof_lock.release()

    # -- HTTP routing (used by metrics.start_http_server) ---------------------

    def handle(self, method, path):
        """Route one request: returns ``(status, json_body)`` — or
        ``(status, raw_body, content_type)`` for non-JSON responses —
        or None for paths this plane does not own (the server falls
        through to ``/metrics`` handling). ``path`` may carry a query
        string (``/debug/pprof?seconds=60``)."""
        from urllib.parse import parse_qs

        path, _, query = path.partition("?")
        if method == "GET":
            if path == "/healthz":
                ok, body = self.healthz()
                return (200 if ok else 503), body
            if path == "/readyz":
                ok, body = self.readyz()
                return (200 if ok else 503), body
            if path == "/debug/stacks":
                return 200, self.stacks()
            if path == "/debug/watchdog":
                return 200, self.healthz()[1]
            if path == "/debug/pipeline":
                return 200, self.pipeline_state()
            if path == "/debug/memory":
                return 200, self.memory()
            if path == "/debug/pprof":
                params = parse_qs(query)
                try:
                    seconds = float(params["seconds"][0]) \
                        if "seconds" in params else None
                except ValueError:
                    return 400, {"error": "seconds must be a number"}
                fmt = params.get("format", ["collapsed"])[0]
                if fmt not in ("collapsed", "json"):
                    return 400, {"error": "format must be collapsed "
                                          "or json"}
                return self.pprof(seconds=seconds, format=fmt)
            if path == "/debug/attribution":
                return self.attribution_state()
            if path == "/debug/goodput":
                return self.goodput_state()
        elif method == "POST":
            if path == "/debug/bundle":
                if self._recorder is None:
                    return 404, {"error": "no FlightRecorder attached"}
                bundle = self.trigger_bundle()
                if bundle is None:
                    return 503, {"error":
                                 "bundle commit failed (see logs)"}
                return 200, {"bundle": bundle}
            if path == "/debug/xprof":
                params = parse_qs(query)
                seconds = params.get("seconds", ["1.0"])[0]
                return self.xprof(seconds)
        return None


# -- pod-wide forensics collection ---------------------------------------------

_collected_total = _metrics.REGISTRY.counter(
    "mx_diag_collected_total",
    "Per-rank diagnostic bundles collected onto rank 0 over the kvstore",
    labels=("rank",))


class DiagCollector:
    """Ship flight-recorder bundles over the kvstore command channel and
    fan out pod-snapshot requests.

    Parameters
    ----------
    kv : transport — ``rank`` plus the diag commands
        (``diag_push(name, blob)``, ``diag_pull()``,
        ``diag_request(kind, msg)``, ``diag_request_check()``):
        ``KVStoreDist`` or a ``LocalBus`` endpoint.
    recorder : this rank's FlightRecorder (bundle source, and the
        rate limiter pod-snapshot requests run through).
    profiler : ContinuousProfiler, optional (default: the process's
        active one at capture time) — :meth:`request_pod_profile`
        fan-outs make every rank push its collapsed capture
        (``profile.rank<R>.<seq>.collapsed``) over the same channel,
        so rank 0 assembles one merged pod profile with no shared
        filesystem.
    directory : rank 0's collected-bundle root; each pulled bundle is
        committed atomically to ``<directory>/rank<R>/<name>`` (the
        layout ``tools/diagnose.py`` expands). Required on rank 0.
    interval_s : ``tick()`` cadence.
    keep_last : retention — newest bundles kept PER RANK directory
        (None = unbounded). The checkpoint ``keep_last`` semantics: GC
        runs after every successful collect, newest survive.
    max_bytes : retention — total byte budget across the whole
        collected tree (None = unbounded); past it, oldest-by-mtime
        bundles are retired regardless of rank. Both bounds compose
        (keep_last first, then the byte cap).
    clock : injectable monotonic clock for tests.

    ``tick()`` from the step loop (or ``start()`` a daemon thread) does
    three things, never raising: (1) answer a pending pod-snapshot
    request by capturing a bundle through the recorder's per-kind rate
    limiter; (2) push this rank's newly committed bundles to server 0;
    (3) on rank 0, pull every rank's pushed bundles into ``directory``.
    The server drains on pull and bounds its per-rank buffer, so a dead
    rank 0 cannot make servers hoard bundles without bound.
    """

    def __init__(self, kv, recorder, directory=None, interval_s=5.0,
                 keep_last=None, max_bytes=None, profiler=None,
                 clock=time.monotonic):
        self._kv = kv
        self._recorder = recorder
        self._profiler = profiler
        self.rank = int(getattr(kv, "rank", 0))
        self.directory = directory
        if self.rank == 0 and directory is None:
            raise ValueError("rank 0 needs directory= to collect into")
        self.keep_last = None if keep_last is None else int(keep_last)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last = None
        self._pushed = 0            # recorder.bundles index already shipped
        # Requests at/below this seq are handled; starts at 0 so a
        # request issued moments before this rank joined still captures
        # (a late-joining rank's fresh state is still a pod snapshot).
        self._handled_seq = 0
        self.collected = []         # paths rank 0 committed
        self._stop = threading.Event()
        self._thread = None

    # -- the three duties -----------------------------------------------------

    def poll_request(self):
        """Answer an outstanding pod-wide request. Bundle requests
        capture through the recorder's rate limiter (suppressed repeats
        are counted, exactly like anomaly triggers) and the bundle
        rides the normal :meth:`push_new` path; ``pod_profile``
        requests push this rank's collapsed profiler capture directly
        (``profile.rank<R>.<seq>.collapsed``, stacks re-rooted under
        ``rank<R>`` so the merged pod profile keeps one lane per rank).
        Returns the bundle path / pushed profile name when one was
        produced."""
        seq, kind, msg = self._kv.diag_request_check()
        if seq <= self._handled_seq:
            return None
        self._handled_seq = seq
        if kind == "pod_profile":
            return self._push_profile(seq, msg)
        if kind == "pod_trace":
            return self._push_trace(seq, msg)
        return self._recorder.request(kind or "pod_snapshot", msg or "")

    def _push_profile(self, seq, msg):
        from . import profiling as _profiling

        profiler = self._profiler if self._profiler is not None \
            else _profiling.active_profiler()
        if profiler is None:
            return None         # nothing to contribute; not an error
        try:
            seconds = float(msg) if msg else None
        except ValueError:
            seconds = None
        capture = _profiling.prefix_collapsed(
            profiler.collapsed(seconds=seconds), "rank%d" % self.rank)
        name = "profile.rank%d.%06d.collapsed" % (self.rank, seq)
        self._kv.diag_push(name, capture.encode("utf-8"))
        return name

    def _push_trace(self, seq, msg):
        """Answer a ``pod_trace`` fan-out: push this rank's buffered
        spans for the requested trace id
        (``xtrace.rank<R>.<seq>.json``). An empty span list is still
        pushed — rank 0's :meth:`collect_trace` can then tell "rank
        answered, trace never touched it" from "rank has not answered
        yet"."""
        import json

        from . import xtrace as _xtrace

        trace_id = (msg or "").strip()
        if not trace_id:
            return None
        blob = json.dumps(
            {"trace_id": trace_id, "rank": self.rank,
             "spans": _xtrace.collect_spans(trace_id)},
            default=str).encode("utf-8")
        name = "xtrace.rank%d.%06d.json" % (self.rank, seq)
        self._kv.diag_push(name, blob)
        return name

    def push_new(self):
        """Ship bundles committed since the last push to server 0.
        Returns how many went out."""
        bundles = self._recorder.bundles
        sent = 0
        while self._pushed < len(bundles):
            path = bundles[self._pushed]
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                self._pushed += 1       # GC'd/unreadable: skip, move on
                continue
            self._kv.diag_push(os.path.basename(path), blob)
            self._pushed += 1
            sent += 1
        return sent

    def collect(self):
        """Rank 0: drain every rank's pushed bundles into
        ``directory/rank<R>/`` (atomic commit per file). Returns the
        paths written this call."""
        from . import export as _export

        if self.rank != 0:
            return []
        written = []
        for rank, bundles in sorted(self._kv.diag_pull().items()):
            rank_dir = os.path.join(self.directory, "rank%d" % rank)
            os.makedirs(rank_dir, exist_ok=True)
            for name, blob in bundles:
                path = os.path.join(rank_dir, os.path.basename(name))
                _export.commit_bytes(path, blob)
                written.append(path)
                _collected_total.labels(rank=str(rank)).inc()
        self.collected.extend(written)
        if written and (self.keep_last is not None
                        or self.max_bytes is not None):
            self.gc()
        return written

    def gc(self):
        """Retention over the collected tree (rank 0): per-rank
        ``keep_last`` newest bundles (names carry a zero-padded seq, so
        lexical order IS capture order — a restart-reset seq falls back
        to mtime like checkpoint GC's torn-step handling), then the
        ``max_bytes`` budget oldest-by-mtime across ranks. Unlinks are
        best-effort: a vanished file is already collected state, not an
        error. Returns the paths removed."""
        if self.rank != 0 or self.directory is None:
            return []
        removed = []
        survivors = []
        try:
            rank_dirs = sorted(
                d for d in os.listdir(self.directory)
                if d.startswith("rank") and
                os.path.isdir(os.path.join(self.directory, d)))
        except OSError:
            return []
        for rd in rank_dirs:
            rank_dir = os.path.join(self.directory, rd)
            # keep_last applies PER KIND (diag bundles vs profile vs
            # trace captures) so a burst of profile pulls cannot evict
            # the incident's diag bundles, and vice versa.
            for prefix in ("diag.", "profile.", "xtrace."):
                try:
                    names = sorted(n for n in os.listdir(rank_dir)
                                   if n.startswith(prefix))
                except OSError:
                    break
                if self.keep_last is None:
                    drop = []
                elif self.keep_last <= 0:
                    # keep_last=0 keeps NOTHING (names[:-0] would keep
                    # everything — the del q[:-0] bug class).
                    drop = list(names)
                else:
                    drop = names[:-self.keep_last]
                for name in drop:
                    path = os.path.join(rank_dir, name)
                    try:
                        os.remove(path)
                        removed.append(path)
                    except OSError:
                        pass
                for name in names[len(drop):]:
                    survivors.append(os.path.join(rank_dir, name))
        if self.max_bytes is not None:
            stats = []
            for path in survivors:
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                stats.append((st.st_mtime, st.st_size, path))
            stats.sort()
            total = sum(s[1] for s in stats)
            for _, size, path in stats:
                if total <= self.max_bytes:
                    break
                try:
                    os.remove(path)
                except OSError:
                    continue
                total -= size
                removed.append(path)
        return removed

    def request_pod_bundle(self, kind="pod_snapshot", msg=""):
        """Fan out an on-demand capture to EVERY rank (rank 0's live
        "dump the pod" button): posts the request on server 0; each
        rank's next ``tick()``/:meth:`poll_request` captures and pushes.
        Returns the request sequence number."""
        return self._kv.diag_request(kind, msg)

    def request_pod_profile(self, seconds=None):
        """Fan out a profile capture to EVERY rank: each rank's next
        ``tick()`` pushes its continuous profiler's last ``seconds`` of
        collapsed stacks; rank 0 collects them into
        ``<dir>/rank<R>/profile.*.collapsed`` — one "what is the whole
        pod doing" flamegraph, no shared filesystem. Returns the
        request sequence number."""
        msg = "" if seconds is None else repr(float(seconds))
        return self._kv.diag_request("pod_profile", msg)

    def request_pod_trace(self, trace_id):
        """Fan out a trace-span capture to EVERY rank: each rank's next
        ``tick()`` pushes its locally buffered spans for ``trace_id``
        (tail-based capture's cross-process leg). Returns the request
        sequence number."""
        return self._kv.diag_request("pod_trace", str(trace_id))

    def collect_trace(self, trace_id, timeout_s=10.0, poll_s=0.05):
        """Rank 0: fan a ``pod_trace`` request out and assemble the
        trace's full cross-process span tree from the per-rank
        replies. Drives this collector's own duties while waiting
        (peer ranks answer on their own tick cadence), returning after
        every known rank answered or ``timeout_s`` — partial trees are
        still forensics. Returns ``{"trace_id", "ranks", "spans"}``
        with each span dict carrying its source ``rank``."""
        if self.rank != 0:
            raise ValueError("collect_trace runs on rank 0")
        self.request_pod_trace(trace_id)
        expected = getattr(self._kv, "num_workers", None)
        deadline = self._clock() + float(timeout_s)
        found = {}
        while True:
            try:
                self.step()
            except Exception:
                pass
            for rank, spans in self._scan_traces(trace_id).items():
                found[rank] = spans
            if expected is not None and len(found) >= expected:
                break
            if self._clock() >= deadline:
                break
            time.sleep(poll_s)
        spans = []
        for rank in sorted(found):
            for event in found[rank]:
                spans.append(dict(event, rank=rank))
        spans.sort(key=lambda e: e.get("ts", 0))
        return {"trace_id": trace_id, "ranks": sorted(found),
                "spans": spans}

    def _scan_traces(self, trace_id):
        """Collected ``xtrace.rank<R>.*.json`` replies for
        ``trace_id``, as ``{rank: spans}`` (rank 0; newest reply per
        rank wins)."""
        import json

        out = {}
        if self.rank != 0 or self.directory is None:
            return out
        try:
            rank_dirs = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for rd in rank_dirs:
            rank_dir = os.path.join(self.directory, rd)
            if not os.path.isdir(rank_dir):
                continue
            try:
                names = sorted(n for n in os.listdir(rank_dir)
                               if n.startswith("xtrace."))
            except OSError:
                continue
            for name in names:
                try:
                    with open(os.path.join(rank_dir, name)) as f:
                        reply = json.load(f)
                except (OSError, ValueError):
                    continue
                if reply.get("trace_id") != trace_id:
                    continue
                out[int(reply.get("rank", 0))] = \
                    reply.get("spans") or []
        return out

    def feed_recorder(self, recorder):
        """Wire collected peer-rank spans into a FlightRecorder's
        bundles: registers an ``xtrace_peers`` extra source that, at
        capture time, resolves every flagged trace against the replies
        this collector has already pulled — a bundle captured after
        :meth:`collect_trace` carries the full cross-process span tree
        of the offending request. Returns the recorder."""
        recorder.add_source("xtrace_peers", self._peer_traces)
        return recorder

    def _peer_traces(self):
        from . import xtrace as _xtrace

        out = {}
        for entry in _xtrace.flagged():
            tid = entry["trace_id"]
            if tid not in out:
                out[tid] = self._scan_traces(tid)
        return out

    def merged_pod_profile(self):
        """Rank 0: merge every collected ``profile.*.collapsed`` into
        one collapsed-stack text (stacks already carry ``rank<R>``
        roots). Empty string when nothing is collected yet."""
        from . import profiling as _profiling

        if self.rank != 0 or self.directory is None:
            return ""
        captures = []
        try:
            rank_dirs = sorted(os.listdir(self.directory))
        except OSError:
            return ""
        for rd in rank_dirs:
            rank_dir = os.path.join(self.directory, rd)
            if not os.path.isdir(rank_dir):
                continue
            try:
                names = sorted(n for n in os.listdir(rank_dir)
                               if n.startswith("profile."))
            except OSError:
                continue
            for name in names:
                try:
                    with open(os.path.join(rank_dir, name)) as f:
                        captures.append(f.read())
                except OSError:
                    continue
        if not captures:
            return ""
        from . import flamegraph as _flamegraph

        return _flamegraph.render_collapsed(
            _profiling.merge_collapsed(captures))

    # -- cadence --------------------------------------------------------------

    def step(self):
        """One unconditional round of all three duties (transport
        errors propagate — ``tick()`` wraps them)."""
        self.poll_request()
        self.push_new()
        return self.collect()

    def tick(self):
        """Step-loop cadence call: one round per ``interval_s``;
        failures are warned rate-limited and retried next interval."""
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            return None
        self._last = now
        try:
            return self.step()
        except Exception as exc:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "diag_collect:%d" % id(self), 30.0,
                "diag collection round failed (will retry): %s", exc)
            return None

    def start(self):
        """Run :meth:`step` every ``interval_s`` on a daemon thread
        (returns self). Same thread-safety caveat as
        ``Aggregator.start``: only drive a dist kvstore from here when
        the training loop is not also using its connections."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    try:
                        self.step()
                    except Exception as exc:
                        _log.warn_rate_limited(
                            _log.get_logger("mxnet_tpu_torch.telemetry"),
                            "diag_collect:%d" % id(self), 30.0,
                            "diag collection round failed (will retry): "
                            "%s", exc)

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-diag", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout=5.0):
        """Stop the background thread and run one final round (push
        whatever committed last, collect whatever is pending)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        try:
            self.step()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
