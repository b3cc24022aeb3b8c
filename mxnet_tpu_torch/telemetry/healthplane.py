"""mxnet_tpu_torch.telemetry.healthplane — the readiness registry.

Counterpart of ``mxnet_tpu/telemetry/healthplane.py:88-150``, the part
of that module its data pipeline calls. Long-lived components claim a
slot (:func:`unique_component`) and flip it with :func:`set_ready`: a
``DataPipeline`` once its first batch is delivered. The ``/readyz``
endpoint that reads it, and the rest of the health plane
(:class:`HealthPlane`, :class:`DiagCollector`, ``/debug/xprof``), are
ROADMAP Queue 1 item 9: constructing either raises.
"""
from __future__ import annotations

import threading

from . import metrics as _metrics

__all__ = ["HealthPlane", "DiagCollector", "unique_component",
           "set_ready", "clear_ready", "readiness", "is_ready", "reset"]

_components = {}                # name -> bool (ready?)
_components_lock = threading.Lock()

_ready_gauge = _metrics.REGISTRY.gauge(
    "mx_component_ready",
    "1 when a registered component reports ready (warmup done), else 0",
    labels=("component",))


def unique_component(base):
    """Claim a readiness slot not yet in use: ``base`` first, then
    ``base#2``, ... (each instance owns its slot, so instance B's
    readiness never masks instance A's warmup). The new slot starts NOT
    ready."""
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
    """Drop a component slot (shutdown path)."""
    with _components_lock:
        _components.pop(name, None)
    _ready_gauge.remove(component=name)


def readiness():
    """Plain ``{component: ready}`` view."""
    with _components_lock:
        return dict(_components)


def is_ready():
    """True when every registered component is ready (vacuously true
    with none registered)."""
    with _components_lock:
        return all(_components.values())


def reset():
    """Drop every component slot (test isolation)."""
    with _components_lock:
        names = list(_components)
        _components.clear()
    for name in names:
        _ready_gauge.remove(component=name)


class HealthPlane:
    """The health/readiness/debug endpoints (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HealthPlane (the /healthz, /readyz and /debug endpoints) is "
            "not ported yet: ROADMAP Queue 1 item 9")


class DiagCollector:
    """Pod-wide forensics collection (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DiagCollector is not ported yet: ROADMAP Queue 1 item 9")
