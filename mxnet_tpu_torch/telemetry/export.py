"""Streaming span export with atomic segment commit.

Counterpart of ``mxnet_tpu/telemetry/export.py``, copied: it has no
JAX in it. The port's kvstore server imports its
``StreamingTraceWriter``; ``PushExporter(wire_format="remote_write")``
encodes through the port's copy of ``telemetry.remote_write``.

PR 3's tracing was dump-at-end: a multi-hour job's spans only hit disk
if the process exits cleanly and calls ``trace.dump()`` — a preempted
rank loses its whole timeline. This module replaces that with an
incremental writer in the Dapper lineage: the span rings are drained on
a rotation budget (bytes / age) and each batch is committed as an
**immutable newline-delimited trace segment** using the checkpoint
writer's tmp+fsync+rename protocol (the same ``_open_for_write`` /
``_rename`` seams as :mod:`mxnet_tpu_torch.checkpoint.manager`, so the test
suite's ``fault_fs`` fixture injects faults into BOTH subsystems). A
SIGKILL at any byte leaves only fully committed, individually loadable
segments — ``tools/trace_merge.py`` stitches the per-rank segment sets
into one Perfetto timeline with one lane per rank.

Segment format (``trace.rank<R>.<SEQ>.jsonl``): one JSON object per
line. The first line is a header ::

    {"meta": {"format": "mxnet_tpu.trace_segment/1", "pid": ..,
              "rank": .., "seq": .., "dropped": ..,
              "wall_anchor_us": .., "perf_anchor_us": ..}}

(``dropped`` counts spans lost to ring overflow since the previous
segment — the merger annotates the gap instead of splicing silently)

and every following line is a chrome trace event (``ph``/``name``/
``ts``/``pid``/``tid`` + ``dur`` for complete events), including
``thread_name`` metadata events for every thread appearing in the
segment — each segment is self-contained. The wall/perf anchor pair
lets the merger rebase each process's ``time.perf_counter`` timestamps
onto the shared wall clock so rank lanes align on one timeline.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

from collections import deque

from . import metrics as _metrics
from . import trace as _trace
from .. import log as _log

__all__ = ["StreamingTraceWriter", "PushExporter", "commit_bytes",
           "default_rank", "SEGMENT_FORMAT", "segment_name", "SEGMENT_RE"]

SEGMENT_FORMAT = "mxnet_tpu.trace_segment/1"
SEGMENT_RE = re.compile(r"^trace\.rank(\d+)\.(\d+)\.jsonl$")


def default_rank():
    """This process's rank in the pod: ``parallel.dist`` when
    initialized, else the launcher's ``DMLC_WORKER_ID``, else 0."""
    try:
        from ..parallel import dist as _dist

        if _dist.is_initialized():
            return _dist.rank()
    except Exception:
        pass
    try:
        return int(os.environ.get("DMLC_WORKER_ID", "0"))
    except ValueError:
        return 0


def segment_name(rank, seq):
    return "trace.rank%d.%06d.jsonl" % (rank, seq)


def commit_bytes(path, data):
    """Write ``data`` to ``path`` via staging-file + fsync + one atomic
    rename — the checkpoint manager's single-file commit, through its
    fault-injectable IO seams. Raises OSError (staging file removed,
    target untouched) on failure."""
    from ..checkpoint import manager as _ckpt

    tmp = "%s.tmp.%d" % (path, os.getpid())
    f = _ckpt._open_for_write(tmp)
    try:
        try:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        finally:
            f.close()
        _ckpt._rename(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _ckpt._fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path


class StreamingTraceWriter:
    """Incrementally flush the span rings to committed trace segments.

    Parameters
    ----------
    directory : segment directory (created if missing; shared across
        ranks — the rank is encoded in every segment name).
    rank : lane id for this process (default :func:`default_rank`).
    max_segment_bytes : commit the pending batch once its serialized
        size reaches this (rotation by size; default 2 MiB).
    max_segment_age_s : commit once the oldest pending event has waited
        this long (rotation by age; default 30 s — an observer is never
        more than one budget behind a live job).
    clock : injectable monotonic clock for tests.

    ``tick()`` is the step-loop entry point: drains the rings (cheap; a
    handful of popleft calls when idle) and commits only when a budget
    trips — commit failures are warned rate-limited and retried on the
    next tick, never raised into the training loop. ``flush()`` commits
    unconditionally and does raise, for shutdown paths that must know.
    Committed segments are immutable; a kill between commits loses at
    most one budget's worth of spans.
    """

    def __init__(self, directory, rank=None, max_segment_bytes=2 << 20,
                 max_segment_age_s=30.0, clock=time.monotonic):
        self.directory = directory
        self.rank = default_rank() if rank is None else int(rank)
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segment_age_s = float(max_segment_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._lines = []            # serialized, not-yet-committed lines
        self._bytes = 0
        self._oldest = None         # clock() when _lines went non-empty
        self._dropped = 0           # ring-overflow drops pending a header
        self._named = set()         # tids already announced this segment
        self._closed = False
        self.committed = []         # segment paths this writer produced
        os.makedirs(directory, exist_ok=True)
        # Resume-safe sequencing: a restarted process must extend the
        # segment set, not overwrite it.
        self._seq = 1 + max(
            (int(m.group(2)) for m in map(SEGMENT_RE.match,
                                          os.listdir(directory))
             if m and int(m.group(1)) == self.rank), default=0)
        self._anchor = {"wall_anchor_us": time.time() * 1e6,
                        "perf_anchor_us": time.perf_counter() * 1e6}

    # -- ingest ---------------------------------------------------------------

    def _append_locked(self, thread_name, tid, events):
        pid = os.getpid()
        if tid not in self._named:
            self._named.add(tid)
            self._lines.append(json.dumps(
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "ts": 0, "args": {"name": thread_name}},
                separators=(",", ":")))
            self._bytes += len(self._lines[-1]) + 1
        for ph, name, ts, dur, args in events:
            event = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                     "ts": ts}
            if ph == "X":
                event["dur"] = dur
            elif ph == "i":
                event["s"] = "t"
            if args:
                event["args"] = dict(args)
            # default=str: span(**args) is an open API — a numpy scalar
            # or other non-JSON arg must degrade to its string form, not
            # raise out of the step loop with the batch already drained.
            line = json.dumps(event, separators=(",", ":"), default=str)
            self._lines.append(line)
            self._bytes += len(line) + 1

    def _drain_locked(self):
        drained = _trace.drain()
        # Overflow accounting rides the same harvest: drops since the
        # last drain belong to THIS segment's gap, so they land in its
        # header (trace_merge renders the gap annotation from it).
        self._dropped += _trace.take_dropped()
        if drained and self._oldest is None:
            self._oldest = self._clock()
        for thread_name, tid, events in drained:
            self._append_locked(thread_name, tid, events)

    # -- commit ---------------------------------------------------------------

    def _commit_locked(self):
        """Serialize pending lines into one immutable segment. Pending
        state is cleared only after the rename lands, so a failed commit
        retries with nothing lost."""
        if not self._lines:
            return None
        header = json.dumps(
            {"meta": dict(self._anchor, format=SEGMENT_FORMAT,
                          pid=os.getpid(), rank=self.rank,
                          seq=self._seq, dropped=self._dropped)},
            separators=(",", ":"))
        data = "\n".join([header] + self._lines) + "\n"
        path = os.path.join(self.directory,
                            segment_name(self.rank, self._seq))
        commit_bytes(path, data.encode("utf-8"))
        self._seq += 1
        self._lines = []
        self._bytes = 0
        self._oldest = None
        self._dropped = 0
        self._named = set()
        self.committed.append(path)
        return path

    @property
    def pending_events(self):
        with self._lock:
            return len(self._lines)

    def tick(self):
        """Step-loop cadence call: drain rings, commit when a rotation
        budget (size or age) trips. Never raises — a commit failure is
        warned (rate-limited) and retried next tick."""
        with self._lock:
            if self._closed:
                return None
            self._drain_locked()
            over_size = self._bytes >= self.max_segment_bytes
            over_age = (self._oldest is not None and
                        self._clock() - self._oldest
                        >= self.max_segment_age_s)
            if not (over_size or over_age):
                return None
            try:
                return self._commit_locked()
            except Exception as exc:   # telemetry never kills the loop
                _log.warn_rate_limited(
                    _log.get_logger("mxnet_tpu_torch.telemetry"),
                    "trace_export:%d" % id(self), 30.0,
                    "trace segment commit failed (will retry): %s", exc)
                return None

    def flush(self):
        """Drain and commit whatever is pending (regardless of budget).
        Raises OSError on commit failure — pending events are retained
        for a retry. Returns the committed path, or None if empty."""
        with self._lock:
            self._drain_locked()
            return self._commit_locked()

    def close(self):
        """Final flush (best-effort) and stop accepting ticks."""
        try:
            self.flush()
        except Exception:
            pass
        with self._lock:
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- remote metric export ------------------------------------------------------

_push_total = _metrics.REGISTRY.counter(
    "mx_export_pushes_total",
    "Registry snapshots delivered to the remote push gateway")
_push_failures = _metrics.REGISTRY.counter(
    "mx_export_failures_total",
    "Failed push-gateway deliveries (buffered for retry with backoff)")
_push_dropped = _metrics.REGISTRY.counter(
    "mx_export_dropped_total",
    "Rendered snapshots dropped because the retry buffer was full")
_push_buffered = _metrics.REGISTRY.gauge(
    "mx_export_buffered",
    "Rendered snapshots awaiting (re)delivery to the push gateway")


_TEXT_HEADERS = {"Content-Type":
                 "text/plain; version=0.0.4; charset=utf-8"}


def _http_post(url, body, headers=None):
    """Default PushExporter transport: one stdlib POST (classic text
    exposition headers unless the caller supplies remote-write ones).
    Raises on any network error or HTTP >= 400."""
    import urllib.request

    req = urllib.request.Request(
        url, data=body, method="POST",
        headers=dict(headers or _TEXT_HEADERS))
    with urllib.request.urlopen(req, timeout=10) as resp:
        status = getattr(resp, "status", 200)
        if status >= 400:       # some transports don't raise on 4xx/5xx
            raise OSError("push gateway returned HTTP %d" % status)


class PushExporter:
    """Periodically push a registry's Prometheus exposition to a
    push-gateway URL — the egress half of the health plane, for fleets
    whose monitoring cannot scrape into the pod (batch jobs behind NAT,
    the classic Pushgateway deployment).

    Parameters
    ----------
    url : push-gateway base, e.g. ``http://gateway:9091``. The snapshot
        is POSTed to ``<url>/metrics/job/<job>[/instance/<instance>]``
        (pass a full path containing ``/metrics/`` to override). With
        ``wire_format="remote_write"`` the url is used VERBATIM — pass
        the receiver's write endpoint, e.g.
        ``http://mimir:9009/api/v1/push`` or
        ``http://prom:9090/api/v1/write``.
    registry : what to render — a ``Registry`` or an ``Aggregator``
        (rank 0 passes its aggregator so ONE push describes the whole
        pod). Default: the process-wide registry.
    job, instance : push-gateway grouping labels in the URL path —
        or, under remote write, labels stamped onto every series.
    wire_format : ``"text"`` (default — the classic push-gateway
        exposition) or ``"remote_write"`` — a snappy-compressed
        protobuf ``WriteRequest`` (:mod:`..remote_write`; Prometheus /
        Mimir / Thanos Receive / VictoriaMetrics ingest this). A
        remote-write render failure degrades to ONE classic-text
        snapshot, counted on ``mx_export_failures_total`` — the
        cadence survives an encoding edge case.
    interval_s : snapshot cadence for ``tick()``/``start()``.
    max_buffer : bounded retry buffer of rendered snapshots. While the
        gateway is down, snapshots queue here oldest-first;
        overflow drops the OLDEST (the gateway keeps last-write-wins
        state, so the freshest snapshot is the one that matters) and
        counts ``mx_export_dropped_total``.
    backoff_s / max_backoff_s : exponential retry backoff after a
        failed delivery (1 s doubling to 5 min by default); any
        successful delivery resets it.
    transport : injectable ``fn(url, body_bytes)`` raising on failure —
        tests inject gateway 500s/timeouts without sockets. Default:
        stdlib POST.
    clock : injectable monotonic clock.

    ``tick()`` never raises: a failed delivery counts
    ``mx_export_failures_total``, arms the backoff and leaves the
    snapshot buffered; the step loop is never the casualty of a dead
    gateway.
    """

    def __init__(self, url, registry=None, job="mxnet_tpu", instance=None,
                 interval_s=15.0, max_buffer=8, backoff_s=1.0,
                 max_backoff_s=300.0, transport=None, wire_format="text",
                 clock=time.monotonic):
        if wire_format not in ("text", "remote_write"):
            raise ValueError("wire_format must be 'text' or "
                             "'remote_write' (got %r)" % (wire_format,))
        self.wire_format = wire_format
        if wire_format == "remote_write":
            self.url = url          # the receiver's write endpoint
            self._extra_labels = {"job": job}
            if instance is not None:
                self._extra_labels["instance"] = instance
        else:
            self.url = self._target(url, job, instance)
            self._extra_labels = None
        self._registry = registry
        self.interval_s = float(interval_s)
        self.max_buffer = int(max_buffer)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        # Injected transports keep the 2-arg (url, body) surface;
        # per-snapshot headers (text vs remote-write, and the fallback
        # from one to the other) ride the buffer to the default POST.
        if transport is not None:
            self._send = lambda url, body, headers: transport(url, body)
        else:
            self._send = _http_post
        self._clock = clock
        self._lock = threading.Lock()       # buffer/backoff state only
        self._send_lock = threading.Lock()  # serializes deliveries
        self._buffer = deque()      # rendered snapshots, oldest first
        self._last = None           # clock() of last rendered snapshot
        self._backoff = None        # current backoff, None = healthy
        self._retry_at = None       # clock() gate for the next attempt
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _target(url, job, instance):
        if "/metrics/" in url:
            return url
        path = "/metrics/job/%s" % job
        if instance is not None:
            path += "/instance/%s" % instance
        return url.rstrip("/") + path

    def _render(self):
        """One snapshot as ``(body, headers)`` in the configured wire
        format. A remote-write encoding failure (a duck registry
        without the snapshot surface, an exotic value) degrades to the
        classic text format for THIS snapshot, counted as a failure —
        delivery cadence over format purity."""
        from . import metrics as _m

        reg = self._registry or _m.REGISTRY
        if self.wire_format == "remote_write":
            from . import remote_write as _rw

            try:
                source = reg
                if not hasattr(source, "collect"):
                    # Aggregator duck: render its merged fleet view
                    # when present, else its local source registry.
                    source = getattr(reg, "fleet", None) \
                        or getattr(reg, "_registry", None) \
                        or _m.REGISTRY
                body = _rw.encode_write_request(
                    source, int(time.time() * 1e3),
                    extra_labels=self._extra_labels)
                return body, dict(_rw.CONTENT_HEADERS)
            except Exception as exc:
                _push_failures.inc()
                _log.warn_rate_limited(
                    _log.get_logger("mxnet_tpu_torch.telemetry"),
                    "push_export:rw:%d" % id(self), 30.0,
                    "remote-write encoding failed (falling back to the "
                    "classic text format for this snapshot): %s", exc)
        return reg.render_prometheus().encode("utf-8"), \
            dict(_TEXT_HEADERS)

    @property
    def pending(self):
        with self._lock:
            return len(self._buffer)

    # -- delivery -------------------------------------------------------------

    def _enqueue_locked(self, body):
        if len(self._buffer) >= self.max_buffer:
            self._buffer.popleft()
            _push_dropped.inc()
        self._buffer.append(body)
        _push_buffered.set(len(self._buffer))

    def _flush(self, now, blocking):
        """Deliver buffered snapshots oldest-first with the network call
        made OUTSIDE the state lock — a slow or blackholing gateway must
        never stall ``pending``/``tick()`` callers on another thread. A
        failure arms the exponential backoff and keeps the remainder for
        the next attempt. Returns None without delivering when another
        thread is already mid-delivery and ``blocking`` is False."""
        if not self._send_lock.acquire(blocking=blocking):
            return None
        try:
            while True:
                with self._lock:
                    if not self._buffer:
                        self._backoff = None
                        self._retry_at = None
                        return True
                    head = self._buffer[0]
                try:
                    self._send(self.url, head[0], head[1])
                except Exception as exc:
                    with self._lock:
                        _push_failures.inc()
                        self._backoff = self.backoff_s \
                            if self._backoff is None \
                            else min(2.0 * self._backoff,
                                     self.max_backoff_s)
                        self._retry_at = now + self._backoff
                        buffered = len(self._buffer)
                        backoff = self._backoff
                    _log.warn_rate_limited(
                        _log.get_logger("mxnet_tpu_torch.telemetry"),
                        "push_export:%d" % id(self), 30.0,
                        "push-gateway delivery failed (%d buffered, "
                        "retry in %.1fs): %s", buffered, backoff, exc)
                    return False
                with self._lock:
                    # The bounded enqueue may have dropped this head
                    # while the POST was in flight — only pop it if it
                    # is still the head.
                    if self._buffer and self._buffer[0] is head:
                        self._buffer.popleft()
                    _push_total.inc()
                    _push_buffered.set(len(self._buffer))
                    # ANY successful delivery resets the backoff (the
                    # documented contract): a flapping gateway that
                    # accepts every other POST must not climb toward
                    # max_backoff_s and stretch the push cadence.
                    self._backoff = None
                    self._retry_at = None
        finally:
            self._send_lock.release()

    def push(self):
        """Render one snapshot NOW and attempt delivery (plus any
        backlog). Returns True when the buffer fully drained."""
        body = self._render()
        with self._lock:
            self._last = self._clock()
            self._enqueue_locked(body)
        return self._flush(self._clock(), blocking=True)

    def tick(self):
        """Step-loop cadence call: render once per ``interval_s``;
        retry buffered snapshots once the backoff window passes. Never
        raises, and never queues behind a delivery already in flight on
        another thread (it returns None and leaves the snapshot
        buffered for that delivery to drain)."""
        now = self._clock()
        body = None
        with self._lock:
            due = self._last is None or now - self._last >= self.interval_s
            if due:
                self._last = now
        if due:
            try:
                body = self._render()
            except Exception as exc:        # a broken duck registry
                _log.warn_rate_limited(
                    _log.get_logger("mxnet_tpu_torch.telemetry"),
                    "push_export:render:%d" % id(self), 30.0,
                    "push-export render failed (will retry): %s", exc)
        with self._lock:
            if body is not None:
                self._enqueue_locked(body)
            if not self._buffer or \
                    (self._retry_at is not None and now < self._retry_at):
                return None
        return self._flush(now, blocking=False)

    # -- background mode ------------------------------------------------------

    def start(self):
        """Push every ``interval_s`` from a daemon thread (returns
        self)."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(
                        min(self.interval_s, self._backoff or
                            self.interval_s)):
                    self.tick()

            self._thread = threading.Thread(
                target=loop, name="mx-telemetry-push", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout=5.0):
        """Stop the thread and attempt one final delivery so the
        gateway holds this process's last state."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        try:
            self.push()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
