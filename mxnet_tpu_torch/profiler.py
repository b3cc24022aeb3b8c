"""mx.profiler — profiling over torch.profiler plus framework-level
aggregate statistics.

Counterpart of ``mxnet_tpu/profiler.py`` (reference:
python/mxnet/profiler.py:29-257 — set_config/set_state/pause/resume/
dump/dumps and the user-defined Domain/Task/Frame/Counter/Marker — over
src/profiler/profiler.h:256, which wrote one chrome://tracing JSON).
Two layers, as in the JAX package:

1. Device level — ``torch.profiler``: ``set_state('run')`` starts a
   session and ``dump()`` writes it as ONE chrome-trace JSON where
   ``set_config(filename=...)`` says (``profile_output.json`` by
   default; a name without ``.json`` gets it), as the reference does.
   The JAX package writes a directory instead (``jax.profiler``'s
   XPlane capture, plus its span rings as ``chrome_trace.json``); the
   port's framework spans stay in ``telemetry.trace`` (``trace.dump``).
   The session records CPU operators and, in a process that may use the
   card, CUDA activity: every kernel the process launches, whichever
   thread launched it. A kvstore server or scheduler (``DMLC_ROLE``)
   profiles the CPU only and never initialises CUDA. One torch.profiler
   session runs in a process at a time (:func:`open_session`), so
   ``set_state('run')`` raises while a health plane's ``/debug/xprof``
   capture runs, and the capture answers 409 while a session runs.
   ``pause``/``resume`` stop and restart the session's collection
   (``toggle_collection_dynamic``) and the dispatch table below.
   A session opens its window after a primer: torch.profiler (2.11 on
   an H100) drops the first kernel records after it enables CUDA
   activity, more of them the older the process (``profile_trace_loss``:
   none of 72 at 15 s, 40 at 600 s; a sleep before the first kernel
   keeps none of them). So
   :class:`_Session` enables CUDA activity (``prepare_trace``), launches
   :func:`_primer_launches` one-element kernels on the current card and
   synchronises, and only then opens the window (``start_trace``): the
   lost records are the primer's, outside the window.
2. Framework level — a view over ``telemetry.REGISTRY``: while the
   profiler runs, the op registry's dispatch path records each
   operator's host dispatch time into the ``mx_dispatch_seconds``
   histogram family (exact count/total/min/max per op; the dispatch is
   timed, never synchronised, so a CUDA op's time is its enqueue),
   user-defined Counters live in the ``mx_profiler_counter`` gauge
   family, and Task/Frame/Marker events go to the bounded
   ``telemetry.trace`` rings. :func:`dumps` renders the tables.

``profile_process='server'`` forwards each call to every kvstore server
(:func:`set_kvstore_handle` first), as the reference's
KVStoreServerProfilerCommand does.

Reset semantics: ``dumps(reset=True)`` clears the per-op dispatch
statistics only. User-defined Counters are live process-global gauges
(``checkpoint::pending``) shared across subsystems — they survive reset.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .telemetry import metrics as _tm
from .telemetry import trace as _trace

__all__ = ["set_config", "profiler_set_config", "set_state",
           "profiler_set_state", "pause", "resume", "dump", "dumps",
           "set_kvstore_handle", "server_dumps", "open_session",
           "export_trace", "Domain", "Task", "Frame", "Counter", "Marker"]

_state = {
    "running": False,
    "paused": False,
    "config": {"filename": "profile_output", "profile_all": False,
               "profile_symbolic": True, "profile_imperative": True,
               "profile_api": True, "aggregate_stats": True},
    "session": None,        # the running or last stopped session
}

# The families behind this module's tables. Op spans keep exact min/max
# (the histogram tracks extrema beside its exponential buckets).
_dispatch = _tm.REGISTRY.histogram(
    "mx_dispatch_seconds",
    "Framework-level dispatch spans per op (host dispatch cost, not "
    "device cost — device timing lives in the torch.profiler trace)",
    labels=("op",))
_user_counters = _tm.REGISTRY.gauge(
    "mx_profiler_counter",
    "User-defined profiler counters (profiler.Domain/Counter), named "
    "domain::counter",
    labels=("name",))

_kv_handle = [None]

# One torch.profiler session per process: set_state's and a health
# plane's /debug/xprof capture take turns on it.
_session_slot = threading.Lock()


def set_kvstore_handle(kv):
    """Attach a dist kvstore so profile_process='server' calls reach the
    remote servers (reference profiler.py:set_kvstore_handle)."""
    _kv_handle[0] = kv


def _server_cmd(sub, arg=None):
    kv = _kv_handle[0]
    if kv is None or not hasattr(kv, "server_profiler_command"):
        raise RuntimeError(
            "profile_process='server' needs a dist kvstore: call "
            "profiler.set_kvstore_handle(kv) with a dist_* store first")
    return kv.server_profiler_command(sub, arg)


def _activities():
    """CPU, and CUDA in a process that may use the card: never in a
    kvstore server or scheduler, which must not initialise CUDA."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if os.environ.get("DMLC_ROLE", "worker") == "worker" and \
            torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


# The primer (module docstring): a floor, plus launches per second since
# this module's import, four times the records lost a second of process
# age in the measurements (about 0.07).
_PRIMER_FLOOR = 4096
_PRIMER_PER_SECOND = 0.25
_T_IMPORT = time.monotonic()


def _primer_launches():
    return _PRIMER_FLOOR + int(_PRIMER_PER_SECOND
                               * (time.monotonic() - _T_IMPORT))


def _prime(activities):
    """Launch the primer on the current card and wait for it, where the
    session traces CUDA and this process has initialised it."""
    import torch
    from torch.profiler import ProfilerActivity

    if ProfilerActivity.CUDA not in activities or \
            not torch.cuda.is_initialized():
        return
    x = torch.zeros(1, device=torch.device(
        "cuda", torch.cuda.current_device()))
    for _ in range(_primer_launches()):
        x.add_(1)
    torch.cuda.synchronize()


class _Session:
    """One torch.profiler session holding the process's session slot
    from construction until it stops (``with`` or start/stop)."""

    def __init__(self):
        import torch

        self.activities = _activities()
        self.prof = torch.profiler.profile(activities=self.activities)
        self.active = False
        self.trace = None       # the exported chrome trace's bytes

    def start(self):
        try:
            self.prof.prepare_trace()       # CUDA activity on
            _prime(self.activities)
            self.prof.start_trace()         # the window opens
        except BaseException:
            _session_slot.release()
            raise
        self.active = True

    def stop(self):
        if not self.active:
            return
        self.active = False
        try:
            self.prof.stop()
        finally:
            _session_slot.release()

    def toggle(self, on):
        self.prof.toggle_collection_dynamic(on, self.activities)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def open_session():
    """A torch.profiler session over this process's activities, holding
    the one session slot until it stops; None while another session
    runs (the port's, or one started on this thread outside it)."""
    import torch

    if not _session_slot.acquire(blocking=False):
        return None
    if torch.autograd._profiler_enabled():
        _session_slot.release()
        return None
    try:
        return _Session()
    except BaseException:
        _session_slot.release()
        raise


def export_trace(session, path):
    """Write a stopped session's chrome trace to ``path`` atomically and
    return the path. torch.profiler saves a session's results once, so
    the first export keeps the trace's bytes for later ones."""
    from .base import atomic_write

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if session.trace is None:
        tmp = "%s.export.%d" % (path, os.getpid())
        try:
            session.prof.export_chrome_trace(tmp)
            with open(tmp, "rb") as f:
                session.trace = f.read()
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    with atomic_write(path) as f:
        f.write(session.trace)
    return path


def set_config(profile_process="worker", **kwargs):
    """(reference profiler.py:set_config). Accepts the reference's knobs;
    ``filename`` names the chrome-trace file :func:`dump` writes. With
    ``profile_process='server'`` the config is forwarded to every
    kvstore server."""
    if profile_process == "server":
        _server_cmd("set_config", kwargs)
        return
    _state["config"].update(kwargs)


profiler_set_config = set_config


def _trace_path():
    name = _state["config"].get("filename", "profile_output")
    return name if name.endswith(".json") else name + ".json"


def set_state(state="stop", profile_process="worker"):
    """'run' starts the torch.profiler session and op-span recording;
    'stop' ends both (reference profiler.py:set_state).
    ``profile_process='server'`` toggles the profiler on every kvstore
    server instead."""
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    if profile_process == "server":
        _server_cmd("set_state", state)
        return
    if state == "run" and not _state["running"]:
        session = open_session()
        if session is None:
            raise RuntimeError(
                "profiler.set_state('run'): another torch.profiler "
                "session is running in this process")
        session.start()
        _state["session"] = session
        _state["running"] = True
        _state["paused"] = False
    elif state == "stop" and _state["running"]:
        _state["running"] = False
        _state["session"].stop()


profiler_set_state = set_state


def pause(profile_process="worker"):
    """Suspend the session's collection and op-span recording
    (reference profiler.py:pause)."""
    if profile_process == "server":
        _server_cmd("pause")
        return
    if _state["running"] and not _state["paused"]:
        _state["session"].toggle(False)
    _state["paused"] = True


def resume(profile_process="worker"):
    if profile_process == "server":
        _server_cmd("resume")
        return
    if _state["running"] and _state["paused"]:
        _state["session"].toggle(True)
    _state["paused"] = False


def is_recording():
    return _state["running"] and not _state["paused"]


def record_op_span(name, seconds):
    """Called from the dispatch path for each op while profiling."""
    _dispatch.labels(op=name).observe(seconds)


def dump(finished=True, profile_process="worker"):
    """Write the session's chrome trace where ``set_config(filename=)``
    says (reference profiler.py:dump) and return its path. With
    ``finished`` (the default, reference semantics) the profiler stops;
    ``finished=False`` writes what was captured so far and starts a new
    session, so a long job can dump mid-flight. After
    ``set_state('stop')`` it writes the stopped session. A no-op
    returning None when profiling was never started."""
    if profile_process == "server":
        _server_cmd("dump")
        return None
    session = _state["session"]
    if session is None:
        return None
    running = _state["running"]
    if running:
        set_state("stop")
    path = export_trace(session, _trace_path())
    if running and not finished:
        set_state("run")
    return path


def server_dumps():
    """Aggregate span tables from every kvstore server (beyond the
    reference, whose servers only write local files). Returns a list of
    per-server tables."""
    return _server_cmd("dumps")


def _op_table(reset=False):
    """{op: (calls, total_s, min_s, max_s, p50_s, p99_s)} from the
    dispatch family. With ``reset`` the family is drained before
    reading."""
    items = _dispatch.drain() if reset else _dispatch.collect()
    out = {}
    for (name,), child in items:
        snap = child.snapshot()
        if snap["count"]:
            out[name] = (snap["count"], snap["sum"], snap["min"],
                         snap["max"], child.quantile(0.5),
                         child.quantile(0.99))
    return out


def _counter_table():
    """{'domain::name': value} of the user-counter family."""
    return {name: child.value
            for (name,), child in _user_counters.collect()}


def dumps(reset=False, format="table"):
    """Aggregate statistics (reference profiler.py:dumps).
    ``format='table'`` renders the table; ``format='json'`` returns
    ``{"trace_file", "ops": {name: {calls, total_ms, min_ms, max_ms,
    p50_ms, p99_ms}}, "counters": {"domain::name": value}}``;
    ``format='top'`` the pprof-style top-K self-time view
    (:func:`telemetry.flamegraph.render_top`).

    ``reset=True`` clears the per-op dispatch statistics. User-defined
    Counters are NOT reset: they are live gauges shared process-wide."""
    if format not in ("table", "json", "top"):
        raise ValueError("format must be 'table', 'json' or 'top', "
                         "got %r" % (format,))
    if format == "top":
        from .telemetry import flamegraph as _fg

        text = _fg.render_top()
        if reset:
            _dispatch.drain()
        return text
    ops = _op_table(reset=reset)
    counters = _counter_table()
    if format == "json":
        return json.dumps({
            "trace_file": _trace_path(),
            "ops": {name: {"calls": st[0], "total_ms": st[1] * 1e3,
                           "min_ms": st[2] * 1e3, "max_ms": st[3] * 1e3,
                           "p50_ms": st[4] * 1e3, "p99_ms": st[5] * 1e3}
                    for name, st in ops.items()},
            "counters": counters,
        })
    lines = [
        "Profile Statistics (framework dispatch spans; device timing "
        "is in the trace file %r)" % _trace_path(),
        "%-40s %10s %14s %14s %14s %14s %14s"
        % ("Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
           "P50(ms)", "P99(ms)"),
    ]
    for name in sorted(ops):
        cnt, tot, mn, mx, p50, p99 = ops[name]
        lines.append("%-40s %10d %14.3f %14.3f %14.3f %14.3f %14.3f"
                     % (name, cnt, tot * 1e3, mn * 1e3, mx * 1e3,
                        p50 * 1e3, p99 * 1e3))
    for name in sorted(counters):
        lines.append("%-40s %10s %14s" % (name, "counter",
                                          counters[name]))
    return "\n".join(lines)


class Domain:
    """A namespace for counters, tasks, frames and markers (reference
    profiler.py:Domain)."""

    def __init__(self, name):
        self.name = name

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_marker(self, name):
        return Marker(self, name)

    def __repr__(self):
        return "Domain('%s')" % self.name


class _Span:
    """Task/Frame base: start/stop records one span into the trace
    rings."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        t1 = time.perf_counter()
        if self._t0 is not None:
            _trace.complete(self._qual(), self._t0, t1)
            if is_recording():
                record_op_span(self._qual(), t1 - self._t0)
            self._t0 = None

    def _qual(self):
        return "%s::%s" % (self.domain.name, self.name)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Span):
    pass


class Frame(_Span):
    pass


class Counter:
    """A named value in the registry (gauge semantics: set or
    increment), shown by :func:`dumps` as ``domain::name`` and by
    ``telemetry.render_prometheus()`` as
    ``mx_profiler_counter{name="domain::name"}``."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._child = _user_counters.labels(
            name="%s::%s" % (domain.name, name))
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._child.set(value)

    def increment(self, delta=1):
        self._child.inc(delta)

    def decrement(self, delta=1):
        self._child.inc(-delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        _trace.instant("%s::%s" % (self.domain.name, self.name),
                       scope=scope)
