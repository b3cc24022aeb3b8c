"""mxnet_tpu_torch.telemetry.aggregate — cross-process metric aggregation.

A copy of ``mxnet_tpu/telemetry/aggregate.py``, which imports no JAX.

The metrics registry is single-process: an N-rank SPMD job exposes N
disjoint ``/metrics`` endpoints. Following the Monarch/Prometheus
federation shape, this module makes ONE scrape describe the pod: every
rank periodically serializes its registry into a plain snapshot and
publishes it over the kvstore's command channel (the same transport
``profiler.server_dumps`` rides — see the ``telemetry_push``/
``telemetry_pull`` commands in :mod:`mxnet_tpu_torch.kvstore_server`); rank 0
pulls all snapshots and merges them into a **fleet registry** where
every series gains a ``rank`` label, so ``render_prometheus()`` /
``start_http_server()`` on rank 0 shows both ranks' counters, gauges
and full histogram bucket vectors side by side.

Staleness is a first-class signal: the fleet registry carries
``mx_rank_last_report_age_seconds{rank}`` and ``mx_rank_stale{rank}``
(age measured on the server's own clock, so worker clock skew cannot
fake liveness), and a rank silent past ``stale_after_s`` is itself an
anomaly — fed to the :class:`~mxnet_tpu_torch.telemetry.health.StepMonitor`
(kind ``rank_stale``) each aggregation interval until it reports again,
exactly like the reference's dead-node detection feeds
``get_dead_nodes``.

Transports are duck-typed (``rank``, ``num_workers``,
``telemetry_push(blob)``, ``telemetry_pull()``): ``KVStoreDist``
implements them over the parameter-server wire; :class:`LocalBus`
provides the in-process equivalent for tests, benches and
single-process jobs.
"""
from __future__ import annotations

import math
import threading
import time

from . import metrics as _metrics
from .. import log as _log

__all__ = ["Aggregator", "LocalBus", "snapshot_registry",
           "merge_snapshots"]


# -- snapshot (runs on every rank) --------------------------------------------

def snapshot_registry(registry=None):
    """Serialize a registry into a plain, pickle-friendly dict:
    ``{"counters"|"gauges": [{name, help, labels, children:
    [[values, value], ...]}], "histograms": [{name, help, labels,
    buckets, children: [[values, {counts, sum, count, min, max}]]}]}``.
    Raw per-bucket counts (not cumulative) so merge is a field copy."""
    reg = registry or _metrics.REGISTRY
    out = {"counters": [], "gauges": [], "histograms": []}
    for fam in reg.collect():
        if fam.kind == "histogram":
            children = []
            for values, child in fam.collect():
                with child._lock:
                    rec = {"counts": list(child._counts),
                           "sum": child._sum, "count": child._count,
                           "min": None if child._count == 0
                           else child._min,
                           "max": None if child._count == 0
                           else child._max}
                children.append([list(values), rec])
            out["histograms"].append(
                {"name": fam.name, "help": fam.help,
                 "labels": list(fam.labelnames),
                 "buckets": list(fam.buckets), "children": children})
        elif fam.kind in ("counter", "gauge"):
            out[fam.kind + "s"].append(
                {"name": fam.name, "help": fam.help,
                 "labels": list(fam.labelnames),
                 "children": [[list(values), child.value]
                              for values, child in fam.collect()]})
    return out


# -- merge (runs on rank 0) ---------------------------------------------------

def _rank_label(labels):
    # A family that already uses "rank" keeps its own; the merged-in
    # process rank then lands under "src_rank".
    return "src_rank" if "rank" in labels else "rank"

def _merge_family(fleet, kind, fam_snap, rank):
    labels = list(fam_snap["labels"])
    rlabel = _rank_label(labels)
    names = tuple(labels) + (rlabel,)
    if kind == "histogram":
        family = fleet.histogram(fam_snap["name"], fam_snap["help"],
                                 names, buckets=fam_snap["buckets"])
    else:
        family = getattr(fleet, kind)(fam_snap["name"], fam_snap["help"],
                                      names)
    for values, rec in fam_snap["children"]:
        labelvalues = dict(zip(labels, values))
        labelvalues[rlabel] = str(rank)
        child = family.labels(**labelvalues)
        # Direct field assignment (same package): counters have no
        # set(), and the enabled() gate must not drop merged values.
        with child._lock:
            if kind == "histogram":
                if len(rec["counts"]) != len(family.buckets) + 1:
                    continue    # bucket-bound drift across versions
                child._counts = list(rec["counts"])
                child._sum = rec["sum"]
                child._count = rec["count"]
                child._min = math.inf if rec["min"] is None else rec["min"]
                child._max = -math.inf if rec["max"] is None \
                    else rec["max"]
            else:
                child._value = rec


def merge_snapshots(snaps, merged_rank="all"):
    """Merge ``{rank: snapshot}`` into a fresh fleet
    :class:`~mxnet_tpu_torch.telemetry.metrics.Registry` with every series
    labeled by its source rank. Families that collide across ranks with
    incompatible declarations are skipped (warned rate-limited) rather
    than failing the whole merge.

    Histogram families additionally get a ``sum without (rank)`` merged
    view: for every child label set, the per-rank bucket vectors /
    sum / count / extrema are summed into one extra series labeled
    ``rank=<merged_rank>`` (default ``"all"``; pass None to skip), so
    fleet-wide p50/p99 derive from ONE series instead of N per-rank
    quantiles that cannot be averaged."""
    fleet = _metrics.Registry()
    for rank in sorted(snaps):
        snap = snaps[rank]
        for kind, key in (("counter", "counters"), ("gauge", "gauges"),
                          ("histogram", "histograms")):
            for fam_snap in snap.get(key, ()):
                try:
                    _merge_family(fleet, kind, fam_snap, rank)
                except ValueError as exc:
                    _log.warn_rate_limited(
                        _log.get_logger("mxnet_tpu_torch.telemetry"),
                        "aggregate:merge:%s" % fam_snap.get("name"),
                        300.0, "fleet merge skipped %r: %s",
                        fam_snap.get("name"), exc)
    if merged_rank is not None:
        _merge_histogram_totals(fleet, snaps, str(merged_rank))
        _merge_counter_totals(fleet, snaps, str(merged_rank))
    return fleet


def _merge_counter_totals(fleet, snaps, merged_rank):
    """The counter analog of the histogram ``sum without (rank)`` pass:
    per-rank counter children are summed into one extra
    ``rank=<merged_rank>`` series per label set, so fleet totals (pod
    goodput seconds, pod shed counts) read as ONE series instead of a
    client-side sum over N ranks. Gauges are deliberately skipped —
    summing them is only meaningful per family, not in general."""
    totals = {}          # (name, labels, values) -> [help, total]
    for rank in sorted(snaps):
        for fam_snap in snaps[rank].get("counters", ()):
            labels = tuple(fam_snap["labels"])
            for values, value in fam_snap["children"]:
                key = (fam_snap["name"], labels, tuple(values))
                acc = totals.get(key)
                if acc is None:
                    totals[key] = [fam_snap["help"], value]
                else:
                    acc[1] += value
    for (name, labels, values), (help_, total) in totals.items():
        rlabel = _rank_label(labels)
        try:
            family = fleet.counter(name, help_, labels + (rlabel,))
        except ValueError:
            continue    # incompatible redeclaration, warned above
        labelvalues = dict(zip(labels, values))
        labelvalues[rlabel] = merged_rank
        child = family.labels(**labelvalues)
        with child._lock:
            child._value = total


def _merge_histogram_totals(fleet, snaps, merged_rank):
    """The registry-side ``sum without (rank)`` pass: accumulate every
    histogram child's raw bucket counts across ranks and write the total
    as one extra ``rank=<merged_rank>`` series. Children whose bucket
    vector length drifted from the declared bounds are skipped exactly
    like the per-rank merge skips them."""
    totals = {}          # (name, labels, buckets, values) -> accum
    for rank in sorted(snaps):
        for fam_snap in snaps[rank].get("histograms", ()):
            buckets = tuple(fam_snap["buckets"])
            labels = tuple(fam_snap["labels"])
            for values, rec in fam_snap["children"]:
                if len(rec["counts"]) != len(buckets) + 1:
                    continue
                key = (fam_snap["name"], labels, buckets, tuple(values))
                acc = totals.get(key)
                if acc is None:
                    totals[key] = {
                        "help": fam_snap["help"],
                        "counts": list(rec["counts"]),
                        "sum": rec["sum"], "count": rec["count"],
                        "min": math.inf if rec["min"] is None
                        else rec["min"],
                        "max": -math.inf if rec["max"] is None
                        else rec["max"]}
                else:
                    acc["counts"] = [a + b for a, b in
                                     zip(acc["counts"], rec["counts"])]
                    acc["sum"] += rec["sum"]
                    acc["count"] += rec["count"]
                    if rec["min"] is not None:
                        acc["min"] = min(acc["min"], rec["min"])
                    if rec["max"] is not None:
                        acc["max"] = max(acc["max"], rec["max"])
    for (name, labels, buckets, values), acc in totals.items():
        rlabel = _rank_label(labels)
        try:
            family = fleet.histogram(name, acc["help"],
                                     labels + (rlabel,),
                                     buckets=list(buckets))
        except ValueError:
            continue    # incompatible redeclaration, warned above
        labelvalues = dict(zip(labels, values))
        labelvalues[rlabel] = merged_rank
        child = family.labels(**labelvalues)
        with child._lock:
            child._counts = list(acc["counts"])
            child._sum = acc["sum"]
            child._count = acc["count"]
            child._min = acc["min"]
            child._max = acc["max"]


# -- in-process transport -----------------------------------------------------

class LocalBus:
    """In-process stand-in for the kvstore telemetry channel: N logical
    ranks sharing one store (tests, benches, single-process jobs).
    ``endpoint(rank)`` returns an object with the same four-member
    transport surface ``KVStoreDist`` exposes."""

    # Bounded per-rank diag-bundle buffer, matching the kvstore server's
    # own bound so LocalBus tests exercise the same drop behavior.
    MAX_DIAG_PER_RANK = 16

    # Compile-cache buffer bound (bytes), matching the kvstore server's
    # MXNET_PS_CC_BUFFER_MB default so LocalBus tests exercise the same
    # drop-oldest behavior.
    MAX_CC_BYTES = 256 << 20

    def __init__(self, num_workers=1, clock=time.monotonic):
        self.num_workers = int(num_workers)
        self._clock = clock
        self._lock = threading.Lock()
        self._store = {}            # rank -> (received_at, blob)
        self._diag = {}             # rank -> [(name, blob), ...]
        self._diag_request = (0, None, None)    # (seq, kind, msg)
        self._cc = {}               # key -> (meta, blob), insertion order
        self._cc_bytes = 0

    def push(self, rank, blob):
        with self._lock:
            self._store[int(rank)] = (self._clock(), blob)

    def pull(self):
        now = self._clock()
        with self._lock:
            return {rank: (now - t, blob)
                    for rank, (t, blob) in self._store.items()}

    # -- diag channel (healthplane.DiagCollector rides this) ------------------

    def diag_push(self, rank, name, blob):
        with self._lock:
            q = self._diag.setdefault(int(rank), [])
            q.append((name, blob))
            bound = self.MAX_DIAG_PER_RANK
            q[:] = q[-bound:] if bound > 0 else []

    def diag_pull(self):
        with self._lock:
            out, self._diag = self._diag, {}
        return out

    def diag_request(self, kind, msg=""):
        with self._lock:
            seq = self._diag_request[0] + 1
            self._diag_request = (seq, kind, msg)
        return seq

    def diag_request_check(self):
        with self._lock:
            return self._diag_request

    # -- compile-cache channel (compile.distribute rides this) ----------------

    def cc_push(self, key, meta, blob):
        with self._lock:
            old = self._cc.pop(key, None)
            if old is not None:
                self._cc_bytes -= len(old[1])
            bound = self.MAX_CC_BYTES
            if bound > 0 and len(blob) <= bound:
                self._cc[key] = (meta, blob)
                self._cc_bytes += len(blob)
                while self._cc_bytes > bound and self._cc:
                    oldest = next(iter(self._cc))
                    self._cc_bytes -= len(self._cc.pop(oldest)[1])

    def cc_probe(self, keys=None):
        # keys=None enumerates every held key (whole-store prefetch),
        # mirroring the kvstore server's cc_probe contract.
        with self._lock:
            if keys is None:
                return list(self._cc)
            return [k for k in keys if k in self._cc]

    def cc_pull(self, key):
        with self._lock:
            return self._cc.get(key)

    def endpoint(self, rank):
        return _LocalEndpoint(self, int(rank))


class _LocalEndpoint:
    def __init__(self, bus, rank):
        self._bus = bus
        self.rank = rank
        self.num_workers = bus.num_workers

    def telemetry_push(self, blob):
        self._bus.push(self.rank, blob)

    def telemetry_pull(self):
        return self._bus.pull()

    def diag_push(self, name, blob):
        self._bus.diag_push(self.rank, name, blob)

    def diag_pull(self):
        return self._bus.diag_pull()

    def diag_request(self, kind, msg=""):
        return self._bus.diag_request(kind, msg)

    def diag_request_check(self):
        return self._bus.diag_request_check()

    def cc_push(self, key, meta, blob):
        self._bus.cc_push(key, meta, blob)

    def cc_probe(self, keys=None):
        return self._bus.cc_probe(keys)

    def cc_pull(self, key):
        return self._bus.cc_pull(key)


# -- the aggregator -----------------------------------------------------------

class Aggregator:
    """Pod-scale metric aggregation over a kvstore-shaped transport.

    Every rank constructs one (``Aggregator(kv).start()`` or ``tick()``
    from the step loop); non-zero ranks only push, rank 0 additionally
    pulls + merges, so ``start_http_server(port, registry=aggregator)``
    on rank 0 serves the whole pod (the aggregator duck-types a
    registry via :meth:`render_prometheus`).

    Parameters
    ----------
    kv : transport — ``rank``, ``num_workers``, ``telemetry_push``,
        ``telemetry_pull`` (``KVStoreDist`` or a ``LocalBus`` endpoint).
    registry : source registry to snapshot (default the process-wide
        ``REGISTRY``).
    interval_s : push/merge cadence for ``start()``/``tick()``.
    stale_after_s : a rank whose last report is older than this is
        marked stale (default ``3 * interval_s``).
    monitor : optional ``StepMonitor`` — stale ranks feed its
        ``rank_stale`` anomaly stream (rate-limited warn +
        ``mx_anomalies_total``).
    clock : injectable monotonic clock for tests.
    """

    def __init__(self, kv, registry=None, interval_s=5.0,
                 stale_after_s=None, monitor=None, clock=time.monotonic):
        self._kv = kv
        self._registry = registry or _metrics.REGISTRY
        self.interval_s = float(interval_s)
        self.stale_after_s = (3.0 * self.interval_s if stale_after_s
                              is None else float(stale_after_s))
        self._monitor = monitor
        self._clock = clock
        self.rank = int(getattr(kv, "rank", 0))
        self.num_workers = int(getattr(kv, "num_workers", 1))
        self._fleet = None          # last merged fleet registry (rank 0)
        self._lock = threading.Lock()
        self._last = None           # clock() of the last step()
        self._started_at = clock()  # grace anchor for never-seen ranks
        self._stop = threading.Event()
        self._thread = None

    # -- one aggregation round ------------------------------------------------

    def step(self):
        """Push this rank's snapshot; on rank 0 also pull every rank's
        and rebuild the fleet view. Returns the fleet registry (rank 0)
        or None. Transport errors propagate — ``tick()`` wraps them."""
        self._last = self._clock()
        self._kv.telemetry_push(snapshot_registry(self._registry))
        if self.rank != 0:
            return None
        reports = self._kv.telemetry_pull()
        fleet = merge_snapshots({r: blob for r, (_, blob)
                                 in reports.items()})
        self._mark_staleness(fleet, reports)
        with self._lock:
            self._fleet = fleet
        return fleet

    def _mark_staleness(self, fleet, reports):
        age_g = fleet.gauge(
            "mx_rank_last_report_age_seconds",
            "Seconds since each rank's last telemetry report "
            "(server clock)", labels=("rank",))
        stale_g = fleet.gauge(
            "mx_rank_stale",
            "1 when a rank's telemetry is older than stale_after_s "
            "(a silent rank is an anomaly, not a gap)",
            labels=("rank",))
        since_start = self._clock() - self._started_at
        for rank in range(self.num_workers):
            if rank in reports:
                age = float(reports[rank][0])
            else:
                # Never reported: age since this aggregator started —
                # a rank that dies before its first push still trips.
                age = since_start
            stale = age > self.stale_after_s
            with age_g.labels(rank=str(rank))._lock:
                age_g.labels(rank=str(rank))._value = age
            with stale_g.labels(rank=str(rank))._lock:
                stale_g.labels(rank=str(rank))._value = int(stale)
            if stale and self._monitor is not None:
                self._monitor.record_anomaly(
                    "rank_stale",
                    "rank %d telemetry silent for %.1fs "
                    "(stale after %.1fs) — rank dead or partitioned"
                    % (rank, age, self.stale_after_s))

    def tick(self):
        """Step-loop cadence call: runs :meth:`step` once per
        ``interval_s``. Transport failures are warned rate-limited and
        retried next interval — aggregation must never take down the
        training loop."""
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            return None
        try:
            return self.step()
        except Exception as exc:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "aggregate:push:%d" % id(self), 30.0,
                "telemetry aggregation round failed (will retry): %s",
                exc)
            return None

    # -- reading --------------------------------------------------------------

    @property
    def fleet(self):
        """The last merged fleet registry (rank 0; None before the
        first round or on other ranks)."""
        with self._lock:
            return self._fleet

    def get(self, name):
        """Registry-duck resolution against the LAST MERGED fleet view
        (None before the first round or on non-zero ranks) — what lets a
        ``ServiceLevelObjective(..., registry=aggregator)`` evaluate
        against the live fleet even though every merge builds a fresh
        Registry object."""
        fleet = self.fleet
        return None if fleet is None else fleet.get(name)

    def fleet_slo(self, name, objective, threshold_s, family,
                  labels=None):
        """Declare a FLEET-level latency SLO: evaluated on this
        aggregator's merged registry, scoped to the ``rank="all"``
        ``sum without (rank)`` series the merge adds per histogram
        family — so burn rates describe the pod's combined traffic, not
        one rank's. Register the result with a ``BurnRateMonitor``
        running on rank 0 (whose gauges/alert counters land in the
        LOCAL registry as usual)::

            burn = telemetry.BurnRateMonitor(monitor=monitor)
            burn.add(agg.fleet_slo("pod_latency", 0.99, 0.25,
                                   "mx_serving_request_latency_seconds"))
        """
        from .slo import ServiceLevelObjective

        labels = dict(labels or {})
        labels.setdefault("rank", "all")
        return ServiceLevelObjective(name, objective, threshold_s,
                                     family, labels=labels,
                                     registry=self)

    def merged_quantile(self, name, q, **labels):
        """Fleet-wide quantile of a histogram family from its
        ``sum without (rank)`` merged series (the ``rank="all"`` child
        the merge adds) — one honest pod p50/p99 instead of N per-rank
        quantiles. Returns None before the first merge or when the
        family/child does not exist."""
        fleet = self.fleet
        if fleet is None:
            return None
        fam = fleet.get(name)
        if fam is None or fam.kind != "histogram":
            return None
        rlabel = "src_rank" if "src_rank" in fam.labelnames else "rank"
        labels[rlabel] = "all"
        try:
            key = tuple(str(labels[l]) for l in fam.labelnames)
        except KeyError:
            return None
        child = fam._children.get(key)   # no get-or-create side effect
        return None if child is None else child.quantile(q)

    def render_prometheus(self, openmetrics=False):
        """Prometheus exposition of the fleet (so the aggregator itself
        can be passed as ``registry=`` to ``start_http_server``). Before
        the first merge — or on non-zero ranks — falls back to the local
        registry, so a scrape is never a 500."""
        fleet = self.fleet
        return (fleet or self._registry).render_prometheus(
            openmetrics=openmetrics)

    # -- background mode ------------------------------------------------------

    def start(self):
        """Run :meth:`step` every ``interval_s`` on a daemon thread
        (returns self). With a ``dist`` kvstore whose connections the
        TRAINING loop also uses (update_on_kvstore pushes/pulls), prefer
        ``tick()`` from the loop thread instead — the pickled-connection
        transport is not thread-safe and a concurrent push would
        interleave frames. A kvstore used only for telemetry (the
        ``-s 0`` SPMD mode trains over XLA collectives, not the PS wire)
        is safe to drive from here."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    try:
                        self.step()
                    except Exception as exc:
                        _log.warn_rate_limited(
                            _log.get_logger("mxnet_tpu_torch.telemetry"),
                            "aggregate:push:%d" % id(self), 30.0,
                            "telemetry aggregation round failed "
                            "(will retry): %s", exc)

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-aggregate", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout=5.0):
        """Stop the background thread (if any) and push one final
        snapshot so rank 0's view includes this rank's last state."""
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
