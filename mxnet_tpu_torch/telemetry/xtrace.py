"""mxnet_tpu_torch.telemetry.xtrace — cross-process causal trace contexts.

A copy of ``mxnet_tpu/telemetry/xtrace.py``, which imports no JAX. The
seams and tools it names below (kvstore wire framing, the gateway, the
flight recorder, ``healthplane``, ``tools/trace_merge.py``) are the JAX
package's; in the port they come with ROADMAP Queue 1 items 7-9.

Dapper-style propagation for the framework's causal chains: a
:class:`TraceContext` (``trace_id``, ``span_id``, ``sampled``) rides a
``contextvars.ContextVar`` so :func:`telemetry.trace.span`
records real parent→child linkage, and a tiny serializable wire form
(:func:`inject` / :func:`extract`) carries the context across every
process seam — the kvstore push/pull framing, the command channel, the
trainer's comm thread, the gateway's request queue. After
``tools/trace_merge.py`` stitches the per-rank segments, every event
stamped with one ``trace_id`` renders as ONE Perfetto flow: a trainer
step's bucket push → server apply → pull round trip, or a gateway
request's admission → queue → batch → device → respond life, each a
single connected arrow chain across rank lanes.

Design rules:

* **Head-based sampling** — the sampled/not decision is made ONCE, at
  :func:`new_root`, by a coin weighted with ``MXNET_TRACE_SAMPLE``
  (probability in [0, 1], default 1.0). An unsampled context still
  propagates (so a downstream sampler sees a consistent decision) but
  stamps nothing — the hot path for an unsampled request is one
  contextvar read.
* **Context managers own restoration** — :func:`activate` (and the
  :func:`start` convenience) set both the contextvar and the
  per-thread table and restore both on exit; the per-thread table is
  what lets the continuous profiler's sampler thread see OTHER
  threads' active contexts (contextvars are not inspectable across
  threads).
* **The wire format is the API** — cross-process payloads must carry
  the context as ``inject()``'s tuple and recover it with
  ``extract()``; the mxlint ``trace-propagation`` checker enforces
  this on new kvstore command payloads.
* **Tail capture hooks** — :func:`flag` marks a trace as anomalous
  (deadline-exceeded, slow_step, SLO burn); the flight recorder reads
  :func:`flagged` and bundles the full span tree of each flagged
  trace, including peer-rank spans collected over the diag channel
  (:meth:`healthplane.DiagCollector.collect_trace`).
"""
from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque

from .. import env as _env

__all__ = ["TraceContext", "current", "new_root", "activate", "start",
           "inject", "extract", "sample_rate", "set_sample_rate",
           "context_of_thread", "flag", "flag_current", "flagged",
           "clear_flags", "collect_spans", "exemplar_value",
           "install_exemplars"]

_WIRE_VERSION = 1


class TraceContext:
    """One position in a causal chain: which trace, which span within
    it, and whether the head sampler kept it."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def __repr__(self):
        return ("TraceContext(trace_id=%r, span_id=%r, sampled=%r)"
                % (self.trace_id, self.span_id, self.sampled))

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id
                and other.sampled == self.sampled)


_current = contextvars.ContextVar("mxnet_tpu_torch_xtrace", default=None)
# thread ident -> active context. The GIL makes single-key dict
# reads/writes atomic; readers (the profiler's sampler) tolerate a
# stale entry for one sample period.
_thread_ctx = {}
_rate = [None]          # cached MXNET_TRACE_SAMPLE; None = re-read env
_rng = random.Random()
# Anomalous traces awaiting tail capture (bounded: forensics, not a log).
_flag_lock = threading.Lock()
_flags = deque(maxlen=16)


def sample_rate():
    """Head-sampling probability (``MXNET_TRACE_SAMPLE``, default 1.0,
    clamped to [0, 1]); cached after the first read."""
    r = _rate[0]
    if r is None:
        try:
            r = float(_env.get("MXNET_TRACE_SAMPLE", 1.0))
        except (TypeError, ValueError):
            r = 1.0
        r = min(1.0, max(0.0, r))
        _rate[0] = r
    return r


def set_sample_rate(rate):
    """Override the cached sampling probability (None = re-read the
    env on next use). Returns the previous cached value."""
    prev = _rate[0]
    _rate[0] = None if rate is None else min(1.0, max(0.0, float(rate)))
    return prev


def _new_id(bits=64):
    return "%x" % _rng.getrandbits(bits)


def current():
    """The active :class:`TraceContext` of this thread/task, or None."""
    return _current.get()


def new_root(sampled=None):
    """Mint a fresh root context. ``sampled=None`` flips the head
    coin; pass True/False to force (tests, replaying a peer's
    decision)."""
    if sampled is None:
        r = sample_rate()
        sampled = r >= 1.0 or _rng.random() < r
    return TraceContext(_new_id(64), _new_id(32), sampled)


class _Activation:
    """Context manager installing ``ctx`` as the current context (and
    into the per-thread table) for the dynamic extent of the block."""

    __slots__ = ("_ctx", "_token", "_tid", "_prev_thread")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._token = _current.set(self._ctx)
        self._tid = threading.get_ident()
        self._prev_thread = _thread_ctx.get(self._tid)
        if self._ctx is None:
            _thread_ctx.pop(self._tid, None)
        else:
            _thread_ctx[self._tid] = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        if self._prev_thread is None:
            _thread_ctx.pop(self._tid, None)
        else:
            _thread_ctx[self._tid] = self._prev_thread
        return False


def activate(ctx):
    """``with xtrace.activate(ctx): ...`` — run the block under ``ctx``
    (``ctx=None`` runs it context-free, masking any outer context —
    how a worker thread isolates per-task contexts)."""
    return _Activation(ctx)


def start(sampled=None):
    """``with xtrace.start() as ctx: ...`` — mint a root context and
    run the block under it (the trace head: a gateway submit, a
    trainer step)."""
    return _Activation(new_root(sampled))


def _push_child(ctx, span_id):
    """Internal (trace.span): replace the current context with a child
    position so nested spans see this span as their parent. Returns the
    contextvar token for :func:`_pop`. The per-thread table keeps the
    trace-level entry (profiler tagging only needs trace identity)."""
    return _current.set(TraceContext(ctx.trace_id, span_id, ctx.sampled))


def _pop(token):
    _current.reset(token)


def inject(ctx=None):
    """Serialize the (given or current) context for a cross-process
    payload: a plain picklable tuple, or None when there is no context.
    The tuple layout is versioned — peers :func:`extract` it without
    caring about this module's internals."""
    if ctx is None:
        ctx = _current.get()
    if ctx is None:
        return None
    return (_WIRE_VERSION, ctx.trace_id, ctx.span_id, ctx.sampled)


def extract(wire):
    """Recover a :class:`TraceContext` from :func:`inject` output.
    Tolerant: None, junk, or a future wire version all yield None —
    a malformed peer must never break the receiver."""
    if not isinstance(wire, tuple) or len(wire) < 4:
        return None
    version, trace_id, span_id, sampled = wire[:4]
    if version != _WIRE_VERSION or not isinstance(trace_id, str) \
            or not isinstance(span_id, str):
        return None
    return TraceContext(trace_id, span_id, bool(sampled))


def context_of_thread(ident):
    """Active context of the thread with OS ident ``ident``, or None —
    the continuous profiler's cross-thread view (contextvars cannot be
    read across threads; the activation table can)."""
    return _thread_ctx.get(ident)


# -- tail-based capture -------------------------------------------------------

def flag(ctx_or_id, kind, note=""):
    """Mark a trace anomalous so tail capture picks it up: the flight
    recorder's next bundle includes the full span tree of every
    flagged trace (local spans + peer-rank spans over the diag
    channel). Accepts a :class:`TraceContext` or a bare trace id."""
    trace_id = getattr(ctx_or_id, "trace_id", ctx_or_id)
    if not trace_id:
        return None
    entry = {"trace_id": trace_id, "kind": kind, "ts": time.time()}
    if note:
        entry["note"] = note
    with _flag_lock:
        _flags.append(entry)
    return entry


def flag_current(kind, note=""):
    """Flag the active context, if any (StepMonitor's anomaly path —
    the detecting thread usually still holds the offending step's
    context)."""
    ctx = _current.get()
    if ctx is None:
        return None
    return flag(ctx, kind, note)


def flagged(clear=False):
    """Snapshot (optionally drain) the flagged-trace list, newest
    last."""
    with _flag_lock:
        out = list(_flags)
        if clear:
            _flags.clear()
    return out


def clear_flags():
    with _flag_lock:
        _flags.clear()


def collect_spans(trace_id):
    """Every buffered event of ``trace_id`` from this process's trace
    rings (non-destructive — the streaming exporter still owns the
    drain). Returns chrome-trace event dicts, time-ordered."""
    from . import trace as _trace

    events = [e for e in _trace.chrome_trace()["traceEvents"]
              if e.get("ph") != "M"
              and (e.get("args") or {}).get("trace_id") == trace_id]
    events.sort(key=lambda e: e.get("ts", 0))
    return events


# -- exemplar linkage ---------------------------------------------------------

def exemplar_value():
    """Trace-aware exemplar source for ``metrics.set_exemplars``: the
    active sampled trace id when a context is live, else the innermost
    open span id, else None."""
    ctx = _current.get()
    if ctx is not None and ctx.sampled:
        return ctx.trace_id
    from . import trace as _trace

    return _trace.current_span_id()


def install_exemplars(on=True):
    """Route histogram/counter exemplars through :func:`exemplar_value`
    so latency observations made under an active context record its
    trace id (and fall back to span ids outside one)."""
    from . import metrics as _metrics
    from . import trace as _trace

    if on:
        _trace.set_span_ids(True)
        _metrics.set_exemplars(True, span_source=exemplar_value)
    else:
        _metrics.set_exemplars(False)
