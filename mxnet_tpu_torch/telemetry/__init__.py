"""mxnet_tpu_torch.telemetry — the framework-wide observability subsystem.

Counterpart of ``mxnet_tpu/telemetry/`` (reference identity:
src/profiler/profiler.h's chrome-trace spans + aggregate tables), every
module of it. Most are copies, since they import no JAX; the others
read PyTorch where the JAX package reads JAX (``memstats`` the CUDA
caching allocator, ``numerics`` ``torch.isfinite``, the ``train_step::
device`` bracket of ``attribution`` a CUDA event, ``recorder``'s
versions, ``healthplane``'s ``/debug/xprof`` torch.profiler).

* :mod:`.metrics` — typed Counter / Gauge / Histogram families with
  labels in the process-wide ``REGISTRY``, ``render_prometheus()`` and
  the stdlib ``start_http_server()`` ``/metrics`` endpoint.
* :mod:`.trace` — thread-aware span recording into bounded per-thread
  rings, flushed to chrome://tracing JSON (``trace.dump()``); spans at
  every layer seam (CachedOp, TrainStep, Trainer, data, checkpoint).
  :mod:`.xtrace` carries causal trace contexts across processes.
* :mod:`.health` — :class:`StepMonitor`: step-time EWMA with slow-step
  outliers, recompile detection through ``CachedOp.on_trace`` and the
  fused applier's ``on_compile``, checkpoint-writer backlog.
* :mod:`.aggregate` — per-rank registry snapshots over the kvstore
  command channel, merged by rank 0 into one fleet registry.
* :mod:`.export` — streamed span segments (``trace.rank<R>.<SEQ>.jsonl``)
  and :class:`PushExporter` (text or ``remote_write``, :mod:`.remote_write`).
* :mod:`.slo` — multi-window error-budget burn rates.
* :mod:`.flamegraph` — top-K self time, collapsed stacks, diffs.
* :mod:`.recorder` — the flight recorder's anomaly-triggered bundles;
  :mod:`.watchdog` — heartbeat lanes and :class:`HangWatchdog`.
* :mod:`.numerics` — :class:`NumericGuard`: cadence-gated isfinite
  checks of the loss and of the fused update's flat buckets.
* :mod:`.memstats` — device memory gauges and ``mx_compile_seconds``.
* :mod:`.healthplane` — ``/healthz``, ``/readyz`` and ``/debug/*`` on
  the ``/metrics`` server, the readiness registry, :class:`DiagCollector`.
* :mod:`.profiling` — :class:`ContinuousProfiler`, the always-on stack
  sampler; :mod:`.attribution` — :class:`StepAttribution`, the per-step
  phase decomposition; :mod:`.goodput` — :class:`GoodputLedger`.

``telemetry.set_enabled(False)`` pauses both metric recording and span
capture.
"""
from __future__ import annotations

from . import metrics
from . import xtrace
from . import trace
from . import aggregate
from . import export
from . import flamegraph
from . import slo
from . import memstats
from . import watchdog
from . import recorder
from . import numerics
from . import healthplane
from . import profiling
from . import attribution
from . import goodput
from . import remote_write
from .metrics import (Registry, REGISTRY, counter, gauge, histogram,
                      render_prometheus, start_http_server,
                      default_buckets, set_exemplars)
from .health import StepMonitor
from .aggregate import Aggregator, LocalBus
from .export import StreamingTraceWriter, PushExporter
from .slo import BurnRateMonitor, ServiceLevelObjective
from .recorder import FlightRecorder
from .watchdog import HangWatchdog
from .numerics import NumericGuard, NonFiniteError
from .memstats import DeviceMemoryMonitor
from .healthplane import HealthPlane, DiagCollector
from .profiling import ContinuousProfiler
from .attribution import StepAttribution
from .goodput import GoodputLedger

__all__ = ["metrics", "xtrace", "trace", "aggregate", "export",
           "flamegraph",
           "slo", "memstats", "watchdog", "recorder", "numerics",
           "healthplane", "profiling", "attribution", "goodput",
           "remote_write",
           "Registry", "REGISTRY", "counter", "gauge",
           "histogram", "render_prometheus", "start_http_server",
           "default_buckets", "set_exemplars", "StepMonitor",
           "Aggregator", "LocalBus", "StreamingTraceWriter",
           "PushExporter", "BurnRateMonitor", "ServiceLevelObjective",
           "FlightRecorder", "HangWatchdog", "NumericGuard",
           "NonFiniteError", "DeviceMemoryMonitor", "HealthPlane",
           "DiagCollector", "ContinuousProfiler", "StepAttribution",
           "GoodputLedger", "set_enabled", "enabled"]


def set_enabled(on):
    """Master switch for the whole subsystem: gates metric recording AND
    span capture. Returns the previous combined state."""
    prev = metrics.enabled() and trace.enabled()
    metrics.set_enabled(on)
    trace.set_enabled(on)
    return prev


def enabled():
    return metrics.enabled() and trace.enabled()
