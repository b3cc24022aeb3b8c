"""mxnet_tpu_torch.telemetry.trace — structured span recording to
chrome://tracing JSON.

A copy of ``mxnet_tpu/telemetry/trace.py``, which imports no JAX; only
``dump`` differs: it commits through the port's ``base.atomic_write``,
where the JAX package's goes through ``telemetry.export.commit_bytes``
(the port's copy of ``telemetry.export`` commits its streamed segment
files that way).
Where the text below says jax.profiler, the port's device truth is
torch.profiler.

The reference profiler wrote chrome-trace JSON spans straight from the
engine (src/profiler/profiler.h:87); here the device truth lives in
jax.profiler's XPlane output, and THIS module records the *framework*
seams — CachedOp trace/execute, TrainStep step/dispatch, serving
enqueue→device→reply, checkpoint snapshot/write/commit — so one
Perfetto load shows queue wait next to device time.

Design:

* **Per-thread bounded rings.** Each recording thread appends tuples to
  its own ``deque(maxlen=capacity)`` (GIL-atomic, no lock on the hot
  path; the global lock is taken once per thread, at ring creation).
  Memory is bounded by construction — a long-running server keeps the
  last ``capacity`` events per thread and silently drops the oldest,
  and rings of dead threads are pruned (newest ``_MAX_DEAD_RINGS``
  retained so short-lived helpers' events survive until the next
  flush), so thread churn cannot grow the registry without bound.
* **Complete events.** Spans are emitted at exit as one chrome ``"X"``
  (complete) event with ``ts``/``dur`` in microseconds; ``instant()``
  emits ``"i"`` markers; ``complete()`` emits retroactive spans from
  explicit perf-counter timestamps (how the serving worker backfills a
  request's queue-wait once it knows when dispatch started).
* **Flush or stream.** ``chrome_trace()`` merges the rings into a
  ``{"traceEvents": [...]}`` dict; ``dump(path)`` writes it as JSON
  loadable in Perfetto / chrome://tracing alongside the XPlane capture
  (atomically — tmp+fsync+rename, so a crash mid-dump leaves the
  previous file, never a truncated unloadable one). For multi-hour jobs
  ``drain()`` detaches the buffered events instead, feeding
  :class:`telemetry.export.StreamingTraceWriter`'s
  incremental segment files.

``set_enabled(False)`` turns ``span()`` bodies into no-ops (one boolean
check) — the tracing half of the telemetry overhead contract.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from . import xtrace as _xtrace

__all__ = ["span", "instant", "complete", "chrome_trace", "dump",
           "drain", "clear", "set_enabled", "enabled", "set_capacity",
           "capacity", "event_count", "set_span_ids", "span_ids_enabled",
           "current_span_id", "take_dropped"]

_DEFAULT_CAPACITY = 16384
# Rings of dead threads retained for the next flush (most recent first
# to go): keeps short-lived helpers' events dumpable while bounding the
# registry under thread churn (a thread-per-request server must not
# accumulate one ring per connection forever).
_MAX_DEAD_RINGS = 32

_state = {"enabled": True, "capacity": _DEFAULT_CAPACITY,
          "span_ids": False}
_registry_lock = threading.Lock()
_rings = []            # [(thread, deque, drops-cell), ...]
_tls = threading.local()
# mx_trace_dropped_spans_total{thread} — created lazily on the first
# drop (trace<->metrics import late-binds through the package).
_dropped_fam = None
# Process-unique span ids (itertools.count.__next__ is atomic under the
# GIL, so no lock on the span hot path).
_span_counter = itertools.count(1)


def set_enabled(on):
    """Enable/disable span recording; returns the previous state."""
    prev = _state["enabled"]
    _state["enabled"] = bool(on)
    return prev


def enabled():
    return _state["enabled"]


def set_capacity(n):
    """Per-thread ring capacity for rings created AFTER this call
    (existing rings keep their bound — they are owned by their threads
    and cannot be swapped safely)."""
    _state["capacity"] = int(n)


def capacity():
    return _state["capacity"]


def set_span_ids(on):
    """Enable per-span ids: every open ``span()`` gets a process-unique
    hex id, readable via :func:`current_span_id` while the span is open
    and carried in the emitted event's args as ``span_id``. This is the
    link exemplars (``metrics.set_exemplars``) and diagnostic bundles
    use to point from a histogram bucket back to the exact trace span
    that fed it. Off by default (one extra append/pop per span when on).
    Returns the previous state."""
    prev = _state["span_ids"]
    _state["span_ids"] = bool(on)
    return prev


def span_ids_enabled():
    return _state["span_ids"]


def current_span_id():
    """Id of the innermost open span on THIS thread, or None (also None
    when span ids are disabled — see :func:`set_span_ids`)."""
    stack = getattr(_tls, "span_ids", None)
    return stack[-1] if stack else None


def _prune_locked():
    """Drop the oldest dead-thread rings beyond _MAX_DEAD_RINGS (caller
    holds _registry_lock). Live threads' rings are never dropped."""
    dead = [entry for entry in _rings if not entry[0].is_alive()]
    for entry in dead[:-_MAX_DEAD_RINGS] if _MAX_DEAD_RINGS else dead:
        _rings.remove(entry)


def _ring():
    ring = getattr(_tls, "ring", None)
    if ring is None:
        thread = threading.current_thread()
        ring = deque(maxlen=_state["capacity"])
        drops = [0]
        with _registry_lock:
            _prune_locked()
            _rings.append((thread, ring, drops))
        _tls.ring = ring
        _tls.drops = drops
    return ring


def _append(record):
    """Ring append with overflow accounting: a full bounded deque drops
    its oldest on append — count that (per-ring cell for the streaming
    segment headers, ``mx_trace_dropped_spans_total{thread}`` for the
    scrape) instead of losing spans silently."""
    ring = _ring()
    if len(ring) == ring.maxlen:
        _tls.drops[0] += 1
        global _dropped_fam
        if _dropped_fam is None:
            from . import metrics as _metrics

            _dropped_fam = _metrics.REGISTRY.counter(
                "mx_trace_dropped_spans_total",
                "spans dropped by per-thread ring overflow",
                labels=("thread",))
        _dropped_fam.labels(
            thread=threading.current_thread().name).inc()
    ring.append(record)


def take_dropped():
    """Total spans dropped by ring overflow since the last call (the
    streaming exporter stamps this into each segment header as
    ``dropped`` so trace_merge can annotate the gap). Best-effort
    under concurrency: a drop racing the harvest lands in the next
    harvest."""
    with _registry_lock:
        entries = list(_rings)
    total = 0
    for _, _, drops in entries:
        n = drops[0]
        if n:
            drops[0] -= n
            total += n
    return total


class _Span:
    """Context manager recording one complete event on exit. Cheap when
    tracing is disabled: no clock read, no ring append. Under an active
    sampled :mod:`xtrace` context the span allocates an id, records
    ``trace_id``/``parent_span_id`` linkage, and installs itself as the
    parent of anything the block opens (including across process seams
    via ``xtrace.inject``)."""

    __slots__ = ("_name", "_args", "_t0", "_id", "_link", "_token",
                 "_pushed")

    def __init__(self, name, args):
        self._name = name
        self._args = args

    def __enter__(self):
        self._id = None
        self._link = None
        self._token = None
        self._pushed = False
        if _state["enabled"]:
            ctx = _xtrace.current()
            traced = ctx is not None and ctx.sampled
            if traced or _state["span_ids"]:
                sid = "%x" % next(_span_counter)
                self._id = sid
                if _state["span_ids"]:
                    stack = getattr(_tls, "span_ids", None)
                    if stack is None:
                        stack = _tls.span_ids = []
                    stack.append(sid)
                    self._pushed = True
                if traced:
                    self._link = (ctx.trace_id, ctx.span_id)
                    self._token = _xtrace._push_child(ctx, sid)
            self._t0 = time.perf_counter()
        else:
            self._t0 = None
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        if self._token is not None:
            _xtrace._pop(self._token)
        if self._pushed:
            # Spans are context-managed, so the per-thread id stack is
            # strictly LIFO.
            stack = getattr(_tls, "span_ids", None)
            if stack:
                stack.pop()
        if t0 is not None:
            t1 = time.perf_counter()
            args = self._args
            if self._id is not None:
                args = dict(args) if args else {}
                args["span_id"] = self._id
                if self._link is not None:
                    args["trace_id"], args["parent_span_id"] = self._link
            _append(("X", self._name, t0 * 1e6, (t1 - t0) * 1e6,
                     args))
        return False


def span(name, **args):
    """``with trace.span("step", step=i): ...`` — records a chrome
    complete event covering the block (thread-local ring)."""
    return _Span(name, args or None)


def _stamp(args):
    """Mark an event with the active sampled trace context (explicit
    caller-passed ids win — the serving worker stamps a REQUEST's
    context onto retroactive events recorded outside its activation)."""
    ctx = _xtrace.current()
    if ctx is not None and ctx.sampled:
        args.setdefault("trace_id", ctx.trace_id)
        args.setdefault("parent_span_id", ctx.span_id)
    return args


def instant(name, **args):
    """Zero-duration marker event."""
    if _state["enabled"]:
        _append(("i", name, time.perf_counter() * 1e6, 0,
                 _stamp(args) or None))


def complete(name, start_s, end_s, **args):
    """Retroactive span from explicit ``time.perf_counter()`` seconds —
    lets a worker emit e.g. a request's queue-wait after the fact."""
    if _state["enabled"]:
        _append(("X", name, start_s * 1e6,
                 max(0.0, end_s - start_s) * 1e6, _stamp(args) or None))


def event_count():
    """Total buffered events across every thread ring."""
    with _registry_lock:
        rings = [entry[1] for entry in _rings]
    return sum(len(r) for r in rings)


def clear():
    """Drop buffered events (live threads' rings stay registered; dead
    threads' rings are released)."""
    with _registry_lock:
        _rings[:] = [entry for entry in _rings if entry[0].is_alive()]
        rings = [entry[1] for entry in _rings]
    for r in rings:
        r.clear()


def _snapshot(ring):
    # A bounded deque mutated concurrently can raise during iteration;
    # events are telemetry, so retry a couple of times and settle for
    # whatever copies cleanly.
    for _ in range(4):
        try:
            return list(ring)
        except RuntimeError:
            continue
    return []


def chrome_trace():
    """Merge every thread ring into a chrome://tracing
    ``{"traceEvents": [...]}`` dict (trace-event JSON array format, the
    one Perfetto and chrome://tracing both load). Each event carries
    ``ph``/``name``/``ts``/``pid``/``tid`` (+ ``dur`` for complete
    events); thread-name metadata events label the tracks."""
    pid = os.getpid()
    events = []
    with _registry_lock:
        rings = list(_rings)
    for thread, ring, _drops in rings:
        tid = thread.ident or 0
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "ts": 0, "args": {"name": thread.name}})
        for ph, name, ts, dur, args in _snapshot(ring):
            event = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                     "ts": ts}
            if ph == "X":
                event["dur"] = dur
            elif ph == "i":
                event["s"] = "t"   # instant scope: thread
            if args:
                event["args"] = dict(args)
            events.append(event)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def drain(prune_dead=True):
    """Detach and return every buffered event, leaving the rings empty
    (the streaming exporter's read path). Returns
    ``[(thread_name, tid, [event tuples])]`` — each tuple is the raw
    ring record ``(ph, name, ts_us, dur_us, args)``. Rings stay
    registered for their live owner threads; drained dead-thread rings
    are released (their events are in the return value, nothing is
    lost). An event appended concurrently with the drain lands in the
    NEXT drain — popleft against the owner's append is safe on a deque.
    """
    with _registry_lock:
        rings = list(_rings)
    out = []
    for thread, ring, _drops in rings:
        events = []
        while True:
            try:
                events.append(ring.popleft())
            except IndexError:
                break
        if events:
            out.append((thread.name, thread.ident or 0, events))
    if prune_dead:
        # A dead ring with an unharvested drop count stays registered
        # until take_dropped() collects it — otherwise the drops of a
        # short-lived thread would vanish with its ring.
        with _registry_lock:
            _rings[:] = [entry for entry in _rings
                         if entry[0].is_alive() or len(entry[1])
                         or entry[2][0]]
    return out


def dump(path="chrome_trace.json"):
    """Write ``chrome_trace()`` to ``path`` atomically; returns the path.

    The write goes through the checkpoint writer's tmp+fsync+rename
    commit (``base.atomic_write``): a
    crash at any byte leaves either the previous dump or a stray tmp
    file, never a truncated JSON that Perfetto refuses to load.
    """
    data = chrome_trace()
    from ..base import atomic_write

    # default=str: span args are an open API — a numpy scalar degrades
    # to its string form instead of failing the whole dump.
    with atomic_write(path) as f:
        f.write(json.dumps(data, default=str).encode("utf-8"))
    return path
