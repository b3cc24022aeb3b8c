"""Per-bucket serving statistics over the unified telemetry registry.

Counterpart of ``mxnet_tpu/serving/metrics.py`` (a copy: it imports no
JAX). Three sinks, same events:

1. **Registry families** (``mxnet_tpu_torch.telemetry.REGISTRY``),
   labeled by ``server`` (a per-instance id, so two servers in one
   process don't blend) and ``bucket``:

   - ``mx_serving_requests_total`` / ``mx_serving_batches_total`` /
     ``mx_serving_rows_total`` — counters per bucket;
   - ``mx_serving_request_latency_seconds`` — a fixed-exponential-bucket
     histogram per bucket: p50/p99 are derived from the buckets (clamped
     to exact min/max), no reservoir needed;
   - ``mx_serving_shed_total{reason}`` — rejected/expired requests, each
     also a ``serving::shed`` trace instant.

   ``snapshot()`` is a *view* over these families — the same numbers a
   Prometheus scrape of ``telemetry.render_prometheus()`` sees.
2. ``serving`` profiler-domain counters (``serving::requests``,
   ``serving::batches``, ``serving::shed_*``) — process-global
   cumulative totals shared across servers, visible in
   ``profiler.dumps()``.
3. ``profiler.record_op_span("serving::bucket_<N>", dt)`` per device
   batch, so the per-bucket device-call table rides the op-dispatch
   aggregate view. Spans are recorded unconditionally, like counters:
   serving stats are cheap aggregates, and operators read them while
   the device profiler is off.
"""
from __future__ import annotations

import itertools
import threading

from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace

__all__ = ["ServingMetrics"]

_ids = itertools.count()


class ServingMetrics:
    def __init__(self, domain="serving", server_id=None):
        from .. import profiler

        self._profiler = profiler
        self._domain = profiler.Domain(domain)
        self._sid = str(server_id) if server_id is not None \
            else "srv-%d" % next(_ids)
        self._lock = threading.Lock()
        self._counters = {}  # name -> profiler.Counter (shared legacy)

        reg = _tm.REGISTRY
        self._requests = reg.counter(
            "mx_serving_requests_total",
            "Requests coalesced into device batches",
            labels=("server", "bucket"))
        self._batches = reg.counter(
            "mx_serving_batches_total", "Device batch calls",
            labels=("server", "bucket"))
        self._rows = reg.counter(
            "mx_serving_rows_total",
            "Real (unpadded) rows executed per bucket",
            labels=("server", "bucket"))
        self._latency = reg.histogram(
            "mx_serving_request_latency_seconds",
            "submit()-to-result latency per request (queueing included)",
            labels=("server", "bucket"))
        self._shed = reg.counter(
            "mx_serving_shed_total",
            "Requests rejected (queue_full) or expired (deadline)",
            labels=("server", "reason"))

    @property
    def server_id(self):
        return self._sid

    def _counter(self, name):
        # Get-or-create under the lock: a creation race (two threads
        # shedding at once) would re-run new_counter(name, 0) and zero
        # a count the other thread already recorded.
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                # No 0-seed: a second server in the same process must
                # not wipe the shared serving-domain counts; increment
                # starts absent keys from 0 anyway.
                c = self._domain.new_counter(name)
                self._counters[name] = c
        return c

    # -- recording ------------------------------------------------------------

    def record_batch(self, bucket, rows, n_requests, seconds):
        """One device call: `n_requests` coalesced into `rows` real rows,
        padded up to `bucket`."""
        self._profiler.record_op_span("serving::bucket_%d" % bucket,
                                      seconds)
        b = str(bucket)
        self._requests.labels(server=self._sid, bucket=b).inc(n_requests)
        self._batches.labels(server=self._sid, bucket=b).inc(1)
        self._rows.labels(server=self._sid, bucket=b).inc(rows)
        self._counter("requests").increment(n_requests)
        self._counter("batches").increment(1)

    def record_request_latency(self, bucket, seconds):
        """submit()-to-result latency of one request (queueing included)."""
        self._latency.labels(server=self._sid,
                             bucket=str(bucket)).observe(seconds)

    def record_shed(self, reason):
        """A request was rejected (`queue_full`) or expired (`deadline`)."""
        self._shed.labels(server=self._sid, reason=reason).inc(1)
        self._counter("shed_" + reason).increment(1)
        _trace.instant("serving::shed", reason=reason)

    # -- reading --------------------------------------------------------------

    def _mine(self, family):
        """This server's children of a (server, X)-labeled family:
        {second_label_value: child}."""
        return {values[1]: child for values, child in family.collect()
                if values[0] == self._sid}

    def snapshot(self):
        """Machine-readable stats — a view over the registry: per-bucket
        occupancy + latency percentiles (histogram-derived), plus shed
        counts."""
        out = {"buckets": {}, "shed": {}}
        for reason, child in self._mine(self._shed).items():
            if child.value:
                out["shed"][reason] = child.value
        batches = self._mine(self._batches)
        requests = self._mine(self._requests)
        rows = self._mine(self._rows)
        latency = self._mine(self._latency)
        for b in sorted(batches, key=int):
            bucket = int(b)
            n_batches = batches[b].value
            n_rows = rows[b].value if b in rows else 0
            lat = latency.get(b)
            out["buckets"][bucket] = {
                "requests": requests[b].value if b in requests else 0,
                "batches": n_batches,
                "mean_occupancy": (n_rows / (n_batches * bucket)
                                   if n_batches else 0.0),
                "p50_ms": (lat.quantile(0.50) if lat else 0.0) * 1e3,
                "p99_ms": (lat.quantile(0.99) if lat else 0.0) * 1e3,
            }
        return out

    def latency_slo(self, objective, threshold_s, name=None):
        """Declare a latency SLO scoped to THIS server's request-latency
        series (all buckets): "``objective`` of requests complete under
        ``threshold_s``". Returns a
        :class:`~mxnet_tpu_torch.telemetry.slo.ServiceLevelObjective` ready
        for ``BurnRateMonitor.add`` — the serving side of the SLO
        burn-rate story::

            burn = telemetry.BurnRateMonitor()
            burn.add(srv.metrics.latency_slo(0.99, 0.250))
            ...
            burn.tick()     # in any loop, or a background timer
        """
        from ..telemetry.slo import ServiceLevelObjective

        return ServiceLevelObjective(
            name or "serving_latency_%s" % self._sid, objective,
            threshold_s, self._latency, labels={"server": self._sid})

    @property
    def total_batches(self):
        return sum(c.value for c in self._mine(self._batches).values())

    @property
    def total_shed(self):
        return sum(c.value for c in self._mine(self._shed).values())

    def close(self):
        """Unregister this server's labeled series from the global
        registry. NOT called by ``InferenceServer.shutdown()`` — stats
        stay readable post-shutdown for draining dashboards and tests —
        but deployments that churn through many short-lived servers
        should call it (via ``srv.metrics.close()``) or the registry
        grows one set of ``server=``-labeled children per instance.
        Shared ``serving::*`` profiler-domain totals are untouched."""
        for fam in (self._requests, self._batches, self._rows,
                    self._latency, self._shed):
            for values, _ in fam.collect():
                if values[0] == self._sid:
                    fam.remove(**dict(zip(fam.labelnames, values)))
