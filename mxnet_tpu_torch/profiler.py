"""mx.profiler — the user-defined profiling objects and the counter table.

Counterpart of ``mxnet_tpu/profiler.py``, in part (reference:
python/mxnet/profiler.py — Domain/Task/Frame/Counter/Marker and
``dumps``). The port keeps the JAX package's user-defined layer over its
``telemetry`` registry:

- a :class:`Counter` is one child of the ``mx_profiler_counter`` gauge
  family, named ``domain::name``: it shows in :func:`dumps` and in
  ``telemetry.render_prometheus()``. The checkpoint manager's
  ``checkpoint::save_seconds``, ``checkpoint::bytes`` and
  ``checkpoint::pending`` live here;
- a :class:`Task` or :class:`Frame` records one span into the bounded
  ``telemetry.trace`` rings per start/stop, a :class:`Marker` an instant.

:func:`dumps` renders the counter table (``format="table"`` or
``"json"``). Counters are live process-wide gauges and survive
``reset=True``, as in the JAX package.

Not ported yet (ROADMAP Queue 1 item 9): the device trace
(``set_config``, ``set_state``, ``dump``, ``pause``/``resume``), the
per-op dispatch table and the server-side commands. They raise.
"""
from __future__ import annotations

import json
import time

from .telemetry import metrics as _tm
from .telemetry import trace as _trace

__all__ = ["set_config", "profiler_set_config", "set_state",
           "profiler_set_state", "pause", "resume", "dump", "dumps",
           "Domain", "Task", "Frame", "Counter", "Marker"]

_user_counters = _tm.REGISTRY.gauge(
    "mx_profiler_counter",
    "User-defined profiler counters (profiler.Domain/Counter), named "
    "domain::counter",
    labels=("name",))


def _item9(what):
    return NotImplementedError(
        "profiler.%s: the device trace and the dispatch table are not "
        "ported yet (ROADMAP Queue 1 item 9); the port's profiler holds "
        "the user-defined counters, tasks, frames and markers" % what)


def set_config(profile_process="worker", **kwargs):
    raise _item9("set_config")


profiler_set_config = set_config


def set_state(state="stop", profile_process="worker"):
    raise _item9("set_state")


profiler_set_state = set_state


def pause(profile_process="worker"):
    raise _item9("pause")


def resume(profile_process="worker"):
    raise _item9("resume")


def dump(finished=True, profile_process="worker"):
    raise _item9("dump")


def _counter_table():
    """{'domain::name': value} of the user-counter family."""
    return {name: child.value
            for (name,), child in _user_counters.collect()}


def dumps(reset=False, format="table"):
    """The counter table (reference profiler.py:dumps). ``format="json"``
    returns ``{"ops": {}, "counters": {"domain::name": value}}``, the
    JAX package's keys (its per-op table is ROADMAP Queue 1 item 9).
    ``reset`` clears nothing: counters are live process-wide gauges."""
    if format not in ("table", "json"):
        raise ValueError("format must be 'table' or 'json' (the 'top' "
                         "view is ROADMAP Queue 1 item 9), got %r"
                         % (format,))
    counters = _counter_table()
    if format == "json":
        return json.dumps({"ops": {}, "counters": counters})
    lines = ["Profile Statistics (user-defined counters)",
             "%-40s %10s %14s" % ("Name", "Kind", "Value")]
    for name in sorted(counters):
        lines.append("%-40s %10s %14s" % (name, "counter", counters[name]))
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
