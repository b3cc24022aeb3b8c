"""mxnet_tpu_torch.telemetry.metrics — the framework-wide metrics registry.

A copy of ``mxnet_tpu/telemetry/metrics.py``, which imports no JAX.

Typed Counter / Gauge / Histogram families with Prometheus-style labels,
designed for the step/dispatch hot path:

* **Lock-sharded.** Every labeled time series (child) owns its own
  ``threading.Lock``; two threads bumping different series never
  contend, and a series lock is held only for the couple of bytecodes of
  the update itself. There is no global lock on the record path — the
  registry/family locks guard only child *creation* and exposition.
* **Histogram = fixed exponential buckets** plus exact sum/count/min/max,
  so p50/p99 are derivable (``Histogram.quantile``) without reservoirs
  and the profiler's aggregate table keeps exact extrema. Bucket
  interpolation is clamped to the observed [min, max], which keeps the
  estimate strictly positive for positive samples.
* **One process-wide default registry** (``REGISTRY``): the profiler's
  op-dispatch spans and user counters, serving, checkpoint and training
  metrics all land here, so ``render_prometheus()`` (or the stdlib
  ``start_http_server`` endpoint) exposes the whole framework at once
  and ``profiler.dumps()`` is a thin view over the same data.
* **Master switch.** ``set_enabled(False)`` turns every record call into
  a cheap boolean check — the bench contract (`bench.py` telemetry
  section) measures the step path in both states.

The exposition format is the Prometheus text format 0.0.4 (``# HELP`` /
``# TYPE`` comments, ``name{label="v"} value`` samples, cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count`` for histograms).
"""
from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left

__all__ = ["Registry", "CounterFamily", "GaugeFamily", "HistogramFamily",
           "MetricsServer", "REGISTRY", "counter", "gauge", "histogram",
           "render_prometheus", "start_http_server", "set_enabled",
           "enabled", "default_buckets", "set_exemplars",
           "exemplars_enabled", "collect_exemplars"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Process-wide master switch, read (one list index) on every record
# call. A list cell, not a module global rebind, so modules that cached
# a reference still see flips.
_enabled = [True]


def set_enabled(on):
    """Enable/disable ALL metric recording (and return the previous
    state). Disabled, every inc/set/observe is a single boolean check —
    this is the "telemetry off" side of the bench overhead contract.
    Functional stats (serving snapshot counts etc.) stop accumulating
    while disabled."""
    prev = _enabled[0]
    _enabled[0] = bool(on)
    return prev


def enabled():
    return _enabled[0]


# Exemplar flag + span-id source. Behind a flag because every observe()
# pays one extra check (and, when a span is open, a tuple store) — the
# default hot path is untouched.
_exemplars = [False]
_span_source = [None]


def set_exemplars(on, span_source=None):
    """Enable OpenMetrics exemplars: each ``Histogram.observe()`` that
    runs inside an open trace span records (span id, value, wall time)
    for the bucket it landed in, and ``render_prometheus(
    openmetrics=True)`` — which the ``/metrics`` endpoint serves to
    scrapers whose Accept header asks for OpenMetrics — appends
    ``# {span_id="..."} value ts`` to that ``_bucket`` line: the link
    from a p99 bucket to the exact span that caused it. The classic
    0.0.4 exposition never carries them (exemplar syntax there fails
    the whole scrape). Enabling also turns on
    :func:`telemetry.trace.set_span_ids` (the id source)
    unless a custom ``span_source`` callable is given. Returns the
    previous state; disabling leaves span ids as they are."""
    prev = _exemplars[0]
    if on:
        if span_source is None:
            from . import trace as _trace

            _trace.set_span_ids(True)
            span_source = _trace.current_span_id
        _span_source[0] = span_source
    _exemplars[0] = bool(on)
    return prev


def exemplars_enabled():
    return _exemplars[0]


def default_buckets(start=1e-4, factor=2.0, count=21):
    """Fixed exponential bucket bounds (seconds): 100µs … ~105s at the
    defaults. Small enough at the bottom for dispatch spans, wide enough
    at the top for checkpoint writes."""
    return tuple(start * factor ** i for i in range(count))


# -- children (one labeled time series each) ----------------------------------

class _CounterChild:
    __slots__ = ("_lock", "_value", "_ex")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0
        self._ex = None          # (span_id, delta, wall_ts)

    def inc(self, delta=1):
        if delta < 0:
            raise ValueError("counters are monotonic; inc by %r" % (delta,))
        if not _enabled[0]:
            return
        ex = None
        if _exemplars[0]:
            src = _span_source[0]
            sid = src() if src is not None else None
            if sid is not None:
                ex = (sid, delta, time.time())
        with self._lock:
            self._value += delta
            if ex is not None:
                self._ex = ex

    @property
    def exemplar(self):
        """Latest (span_id, delta, wall_ts) recorded inside a span, or
        None (``inc_try`` never records one — it must stay
        non-blocking)."""
        with self._lock:
            return self._ex

    def inc_try(self, delta=1):
        """Non-blocking inc for signal-handler/lock-sensitive contexts
        (checkpoint preemption path): on contention the tick is dropped
        rather than ever blocking. Returns whether it was recorded."""
        if not _enabled[0]:
            return False
        if self._lock.acquire(blocking=False):
            try:
                self._value += delta
            finally:
                self._lock.release()
            return True
        return False

    @property
    def value(self):
        with self._lock:
            return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, value):
        if not _enabled[0]:
            return
        with self._lock:
            self._value = value

    def inc(self, delta=1):
        if not _enabled[0]:
            return
        with self._lock:
            self._value += delta

    def dec(self, delta=1):
        self.inc(-delta)

    def inc_try(self, delta=1):
        """Non-blocking inc (see _CounterChild.inc_try)."""
        if not _enabled[0]:
            return False
        if self._lock.acquire(blocking=False):
            try:
                self._value += delta
            finally:
                self._lock.release()
            return True
        return False

    @property
    def value(self):
        with self._lock:
            return self._value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_min", "_max", "_ex")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds              # sorted finite upper bounds
        self._counts = [0] * (len(bounds) + 1)   # last = overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._ex = None          # per-bucket (span_id, value, wall_ts)

    def observe(self, value):
        if not _enabled[0]:
            return
        idx = bisect_left(self._bounds, value)
        ex = None
        if _exemplars[0]:
            src = _span_source[0]
            sid = src() if src is not None else None
            if sid is not None:
                ex = (sid, value, time.time())
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if ex is not None:
                if self._ex is None:
                    self._ex = [None] * (len(self._bounds) + 1)
                self._ex[idx] = ex

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snapshot(self):
        """Consistent point-in-time view: {'count', 'sum', 'min', 'max',
        'buckets': [(upper_bound, cumulative_count), ..., (inf, count)],
        'exemplars': per-bucket (span_id, value, wall_ts) or None}.
        min/max are None when empty."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            mn = None if self._count == 0 else self._min
            mx = None if self._count == 0 else self._max
            ex = None if self._ex is None else list(self._ex)
        cum, buckets = 0, []
        for bound, c in zip(self._bounds, counts):
            cum += c
            buckets.append((bound, cum))
        buckets.append((math.inf, cum + counts[-1]))
        return {"count": total, "sum": s, "min": mn, "max": mx,
                "buckets": buckets, "exemplars": ex}

    def quantile(self, q):
        """Estimate the q-quantile (0 <= q <= 1) by linear interpolation
        within the owning bucket, clamped to the exact observed
        [min, max] — monotone in q, 0.0 when empty."""
        snap = self.snapshot()
        if snap["count"] == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        target = q * snap["count"]
        prev_cum, prev_bound = 0, 0.0
        for bound, cum in snap["buckets"]:
            if cum >= target and cum > prev_cum:
                frac = (target - prev_cum) / (cum - prev_cum)
                hi = snap["max"] if math.isinf(bound) else bound
                est = prev_bound + frac * (hi - prev_bound)
                return min(snap["max"], max(snap["min"], est))
            prev_cum, prev_bound = cum, bound
        return snap["max"]


# -- families -----------------------------------------------------------------

class _Family:
    """All time series of one metric name; children keyed by the tuple
    of label values. With no label names the family has exactly one
    child and delegates the record methods to it."""

    kind = None

    def __init__(self, name, help, labelnames):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                "%s expects labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(labelvalues)))
        key = tuple(str(labelvalues[l]) for l in self.labelnames)
        child = self._children.get(key)   # GIL-atomic read, no lock
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def collect(self):
        """Snapshot of [(label_values_tuple, child)], creation-ordered."""
        with self._lock:
            return list(self._children.items())

    def clear(self):
        """Drop every child (used by profiler.dumps(reset=True))."""
        with self._lock:
            self._children.clear()

    def drain(self):
        """Detach and return ``[(label_values, child)]``, leaving the
        family empty. Snapshot-and-reset for readers: the swap happens
        under the family lock, shrinking the lost-update window to a
        recorder that already resolved its child reference and has not
        yet recorded when the drain runs (that one in-flight update can
        land in the detached child after its snapshot and be dropped —
        the price of a lock-free record path)."""
        with self._lock:
            items = list(self._children.items())
            self._children.clear()
        return items

    def remove(self, **labelvalues):
        key = tuple(str(labelvalues[l]) for l in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    # no-label convenience: family acts as its single child
    def _sole(self):
        return self.labels()


class CounterFamily(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, delta=1):
        self._sole().inc(delta)

    def inc_try(self, delta=1):
        return self._sole().inc_try(delta)

    @property
    def value(self):
        return self._sole().value

    @property
    def exemplar(self):
        return self._sole().exemplar


class GaugeFamily(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value):
        self._sole().set(value)

    def inc(self, delta=1):
        self._sole().inc(delta)

    def dec(self, delta=1):
        self._sole().dec(delta)

    def inc_try(self, delta=1):
        return self._sole().inc_try(delta)

    @property
    def value(self):
        return self._sole().value


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=None):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(buckets)) if buckets else default_buckets()
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value):
        self._sole().observe(value)

    def quantile(self, q):
        return self._sole().quantile(q)

    def snapshot(self):
        return self._sole().snapshot()


# -- registry -----------------------------------------------------------------

class Registry:
    """Name -> family map. get-or-create semantics: re-declaring a
    metric returns the existing family, but a name may never change
    type, label names or (for histograms) bucket bounds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % (name,))
        for l in labels:
            if not _LABEL_RE.match(l):
                raise ValueError("invalid label name %r" % (l,))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labels):
                    raise ValueError(
                        "metric %r already registered as %s%s"
                        % (name, fam.kind, fam.labelnames))
                return fam
            fam = cls(name, help, labels, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()):
        return self._get_or_create(CounterFamily, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(GaugeFamily, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        fam = self._get_or_create(HistogramFamily, name, help, labels,
                                  buckets=buckets)
        if buckets is not None and fam.buckets != tuple(sorted(buckets)):
            raise ValueError("metric %r already registered with buckets %s"
                             % (name, fam.buckets))
        return fam

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def unregister(self, name):
        with self._lock:
            self._families.pop(name, None)

    def collect(self):
        with self._lock:
            return list(self._families.values())

    def render_prometheus(self, openmetrics=False):
        """Text exposition of every family. Default: the classic
        Prometheus format 0.0.4. With ``openmetrics=True``: an
        OpenMetrics-flavored rendering that additionally carries
        recorded exemplars on ``_bucket`` lines and the required
        ``# EOF`` terminator — exemplar syntax is ONLY valid there (a
        classic-format scraper rejects the whole scrape on it), which
        is why the ``/metrics`` endpoint negotiates via the Accept
        header instead of always emitting them."""
        out = []
        for fam in self.collect():
            out.append("# HELP %s %s" % (fam.name, _esc_help(fam.help)))
            out.append("# TYPE %s %s" % (fam.name, fam.kind))
            for values, child in fam.collect():
                base = _labelstr(fam.labelnames, values)
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    exemplars = snap.get("exemplars") if openmetrics \
                        else None
                    for i, (bound, cum) in enumerate(snap["buckets"]):
                        le = "+Inf" if math.isinf(bound) else _fmt(bound)
                        line = "%s_bucket%s %d" % (
                            fam.name,
                            _labelstr(fam.labelnames + ("le",),
                                      values + (le,)),
                            cum)
                        ex = exemplars[i] if exemplars else None
                        if ex is not None:
                            # OpenMetrics exemplar: the trace span that
                            # fed this bucket (metrics.set_exemplars).
                            line += ' # {span_id="%s"} %s %s' % (
                                _esc_label(str(ex[0])), _fmt(ex[1]),
                                _fmt(ex[2]))
                        out.append(line)
                    out.append("%s_sum%s %s" % (fam.name, base,
                                                _fmt(snap["sum"])))
                    out.append("%s_count%s %d" % (fam.name, base,
                                                  snap["count"]))
                else:
                    line = "%s%s %s" % (fam.name, base,
                                        _fmt(child.value))
                    if openmetrics and fam.kind == "counter":
                        ex = child.exemplar
                        if ex is not None:
                            line += ' # {span_id="%s"} %s %s' % (
                                _esc_label(str(ex[0])), _fmt(ex[1]),
                                _fmt(ex[2]))
                    out.append(line)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


def _esc_help(text):
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(value):
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _labelstr(names, values):
    if not names:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (n, _esc_label(str(v)))
                             for n, v in zip(names, values))


def _fmt(value):
    if isinstance(value, float):
        if value == math.inf:
            return "+Inf"
        if value == -math.inf:
            return "-Inf"
        if value == int(value) and abs(value) < 1e15:
            return str(int(value))
        return repr(value)
    return str(value)


# -- default registry + module-level helpers ----------------------------------

REGISTRY = Registry()


def counter(name, help="", labels=(), registry=None):
    return (registry or REGISTRY).counter(name, help, labels)


def gauge(name, help="", labels=(), registry=None):
    return (registry or REGISTRY).gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=None, registry=None):
    return (registry or REGISTRY).histogram(name, help, labels,
                                            buckets=buckets)


def render_prometheus(registry=None, openmetrics=False):
    return (registry or REGISTRY).render_prometheus(
        openmetrics=openmetrics)


def collect_exemplars(registry=None):
    """All recorded exemplars as a plain JSON-able list (the flight
    recorder's bundle view): ``[{metric, labels, le, span_id, value,
    ts}]`` for histogram buckets, the same minus ``le`` for counters.
    Empty when exemplars are disabled or nothing observed inside a span
    yet."""
    reg = registry or REGISTRY
    out = []
    for fam in reg.collect():
        if fam.kind == "counter":
            for values, child in fam.collect():
                ex = child.exemplar
                if ex is None:
                    continue
                out.append({
                    "metric": fam.name,
                    "labels": dict(zip(fam.labelnames, values)),
                    "span_id": ex[0], "value": ex[1], "ts": ex[2]})
            continue
        if fam.kind != "histogram":
            continue
        for values, child in fam.collect():
            snap = child.snapshot()
            exemplars = snap.get("exemplars")
            if not exemplars:
                continue
            for (bound, _), ex in zip(snap["buckets"], exemplars):
                if ex is None:
                    continue
                out.append({
                    "metric": fam.name,
                    "labels": dict(zip(fam.labelnames, values)),
                    "le": "+Inf" if math.isinf(bound) else bound,
                    "span_id": ex[0], "value": ex[1], "ts": ex[2]})
    return out


class MetricsServer:
    """Handle for a running ``/metrics`` endpoint.

    * ``port`` — the BOUND port (meaningful with ``port=0``: ask the OS
      for a free one, read it back here).
    * ``url`` — ready-to-curl scrape address.
    * ``close()`` — shut the server down, release the listening socket,
      and **join the serving thread**, so repeated start/close cycles in
      one process (test suites) neither leak threads nor leave the port
      in use; closing twice is a no-op.

    Back-compat with the previous raw-server return: ``server_address``
    and ``shutdown()`` keep working (``shutdown`` is ``close``).
    """

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread
        self._closed = False
        # Captured at start: server_address is cleared by server_close().
        self._address = server.server_address[:2]

    @property
    def server_address(self):
        return self._address

    @property
    def port(self):
        return self._address[1]

    @property
    def url(self):
        return "http://%s:%d/metrics" % self._address

    def close(self, timeout=5.0):
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()         # stop serve_forever
        self._server.server_close()     # release the listening socket
        self._thread.join(timeout)

    shutdown = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_http_server(port=0, addr="127.0.0.1", registry=None,
                      health=None):
    """Serve ``render_prometheus()`` on ``http://addr:port/metrics`` from
    a daemon thread (stdlib http.server; no dependencies). ``port=0``
    picks a free port. Returns a :class:`MetricsServer` handle — read
    the bound port from ``.port``/``.url``, stop with ``.close()``
    (which also joins the serving thread). ``registry`` accepts anything
    with a ``render_prometheus()`` method — a :class:`Registry` or a
    :class:`~telemetry.aggregate.Aggregator` fleet view.

    ``health`` mounts a
    :class:`~telemetry.healthplane.HealthPlane` next to
    ``/metrics``: ``GET /healthz`` / ``/readyz`` (liveness/readiness
    probes — 200 or 503 with a JSON body) and the ``/debug/*`` views
    (``stacks``/``watchdog``/``pipeline``/``memory`` plus ``POST
    /debug/bundle``). ``/metrics`` exposition — including the
    OpenMetrics Accept negotiation — is unchanged."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def _try_health(self, method):
            if health is None:
                return False
            try:
                # The FULL path, query string included — /debug/pprof
                # takes ?seconds=N&format=...; the plane strips the
                # query for routes that ignore it.
                routed = health.handle(method, self.path)
            except Exception as exc:    # a probe must never hang/close
                routed = (500, {"error": repr(exc)})
            if routed is None:
                return False
            if len(routed) == 3:
                # (status, body, content_type): a raw non-JSON body —
                # /debug/pprof's text/plain collapsed capture.
                status, body, ctype = routed
                if isinstance(body, str):
                    body = body.encode("utf-8")
            else:
                status, obj = routed
                body = _json.dumps(obj, default=str).encode("utf-8")
                ctype = "application/json; charset=utf-8"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return True

        def do_POST(self):
            if not self._try_health("POST"):
                self.send_error(404)

        def do_GET(self):
            if self._try_health("GET"):
                return
            if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            # Content negotiation: exemplars are only legal in the
            # OpenMetrics format, so they are emitted ONLY to scrapers
            # that ask for it — a classic-format scraper keeps getting
            # clean 0.0.4 text (exemplar syntax there fails the whole
            # scrape).
            accept = self.headers.get("Accept", "") or ""
            openmetrics = "application/openmetrics-text" in accept
            try:
                body = reg.render_prometheus(
                    openmetrics=openmetrics).encode("utf-8")
            except TypeError:   # registry-shaped duck without the kwarg
                openmetrics = False
                body = reg.render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8" if openmetrics
                else "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # no stderr chatter per scrape
            pass

    server = ThreadingHTTPServer((addr, port), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="mx-telemetry-http", daemon=True)
    thread.start()
    return MetricsServer(server, thread)
