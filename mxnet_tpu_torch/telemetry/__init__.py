"""Telemetry of the port: the metrics registry and trace spans.

Counterpart of ``mxnet_tpu/telemetry/``, in part. The port has the three
modules of the JAX package that import no JAX, copied: ``metrics`` (the
process-wide ``REGISTRY`` of counters, gauges and histograms with
Prometheus exposition), ``trace`` (chrome-trace spans) and ``xtrace``
(causal trace contexts); since the input pipeline, also ``watchdog``
(heartbeat lanes and the hang watchdog) and the readiness registry of
``healthplane``. The trainer and the fused optimizer apply
record into them (``mx_trainer_update_seconds``,
``mx_fused_apply_compiles_total``, ``mx_trainer_fused_dispatches``).
The rest — export, aggregation, SLOs, memstats, numerics, the flight
recorder, the health plane's endpoints, profiling and attribution — is
ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from . import metrics
from . import xtrace
from . import trace
from . import watchdog
from . import healthplane
from .metrics import (Registry, REGISTRY, counter, gauge, histogram,
                      render_prometheus)

__all__ = ["metrics", "xtrace", "trace", "watchdog", "healthplane", "Registry", "REGISTRY", "counter",
           "gauge", "histogram", "render_prometheus", "set_enabled",
           "enabled"]


def set_enabled(on):
    """Master switch for the whole subsystem: gates metric recording AND
    span capture. Returns the previous combined state."""
    prev = metrics.enabled() and trace.enabled()
    metrics.set_enabled(on)
    trace.set_enabled(on)
    return prev


def enabled():
    return metrics.enabled() and trace.enabled()
