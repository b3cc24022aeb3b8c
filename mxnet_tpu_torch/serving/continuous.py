"""mxnet_tpu_torch.serving.continuous — iteration-level (continuous)
batching for stateful sequence decoding.

Counterpart of ``mxnet_tpu/serving/continuous.py``. The gateway serves
one-shot batches: a request occupies its batch rows for exactly one
device call. Autoregressive decoding breaks that model: a sequence
occupies a batch slot for `len(sequence)` device calls, and a STATIC
batch wastes every slot whose sequence finished early (throughput ~
max(L)/mean(L) below peak at mixed lengths). The fix, per Orca's
iteration-level scheduling and vLLM's paged KV state (PAPERS.md), is to
schedule at STEP granularity:

* A :class:`DecodeLoop` owns the device and runs one iteration at a
  time: retire finished sequences, admit queued requests into the freed
  slots, dispatch exactly ONE decode step over the occupied slots.

* Per-sequence state (the KV-cache-shaped tensors) lives in slot-indexed
  device pages handed out by a :class:`PagedSlotAllocator`: fixed pages
  of ``page_slots`` slots each, lowest-slot-first free-list reuse, no
  per-request device allocation on the hot path. The pages of a state
  tensor are views of one buffer allocated once, so a step over the
  first N pages reads them without a copy and writes them back in
  place; an admit writes one row in place, and a retire just frees the
  slot id (the row is dead until reused).

* No new signature over TIME: batch occupancy quantizes onto the
  model's :class:`~.buckets.BucketPolicy` ladder and each bucket maps
  to a page count, so the step's signature is (page count,): slot churn,
  ragged lengths and admit/retire at every iteration never add one.
  Prompts canonicalize onto a length ladder the same way. The step, the
  row placement and the prefill each run through a signature-counting
  ``CachedOp``, whose new signatures are the events the JAX package's
  trace counter counts.

Telemetry: ``mx_decode_slot_occupancy`` / ``mx_decode_tokens_total`` /
``mx_decode_steps_total`` / ``mx_decode_ttft_seconds`` (all
``{model=...}``), spans ``decode::admit|step|retire|sequence``, one
``decode#N`` watchdog lane per loop.

Composition: the gateway routes ``submit_sequence`` requests onto the
model's loop through the SAME admission pool as one-shot requests
(gateway.py); hot reload swaps the backend only after in-flight
sequences drain on their admit-time generation.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

import torch

from .. import log as _log
from .. import ndarray as nd
from ..base import torch_dtype
from ..cached_op import CachedOp
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import watchdog as _watchdog
from ..telemetry import xtrace as _xtrace
from .admission import DeadlineExceededError, ServiceUnavailableError
from .engine import held_bytes

__all__ = ["DecodeConfig", "PagedSlotAllocator", "DecodeLoop",
           "SequenceResult", "drop_metrics"]

_dc_occupancy = _tm.REGISTRY.gauge(
    "mx_decode_slot_occupancy",
    "Occupied decode batch slots per model", labels=("model",))
_dc_slots = _tm.REGISTRY.gauge(
    "mx_decode_slots",
    "Total decode batch slots per model (the occupancy denominator — "
    "goodput's decode slot-idle fraction divides these two)",
    labels=("model",))
_dc_tokens = _tm.REGISTRY.counter(
    "mx_decode_tokens_total",
    "Generated tokens per model (continuous batching)",
    labels=("model",))
_dc_steps = _tm.REGISTRY.counter(
    "mx_decode_steps_total",
    "Decode-step device dispatches per model", labels=("model",))
_dc_ttft = _tm.REGISTRY.histogram(
    "mx_decode_ttft_seconds",
    "submit-to-first-token latency per sequence (queueing included)",
    labels=("model",))

_logger = _log.get_logger("mxnet_tpu.serving")


def drop_metrics(name):
    """Remove a model's labeled decode series (gateway ``unregister``)."""
    for fam in (_dc_occupancy, _dc_slots, _dc_tokens, _dc_steps,
                _dc_ttft):
        for values, _ in fam.collect():
            if values[0] == name:
                fam.remove(**dict(zip(fam.labelnames, values)))


class DecodeConfig:
    """Decode-side description of a model (``ModelSpec(decode=...)``).

    Parameters
    ----------
    step : callable(*params, state, tokens, pos) -> (state, next_tokens)
        One decode iteration over a batch of R slots: ``state`` is one
        NDArray ``(R,) + state_shape`` (or a tuple of them for multiple
        state tensors), ``tokens``/``pos`` are int32 ``(R,)`` — the last
        emitted token and the position of each slot. Must be pure and
        row-independent (rows belonging to inactive slots are stepped
        too and masked out by the loop).
    state_shape : shape, or sequence of shapes
        Per-slot state tensor shape(s) WITHOUT the slot dim (the
        KV-cache shape).
    init : callable(*params, prompt, length) -> (state, first_token), optional
        Prefill for ONE sequence: ``prompt`` is int32 ``(1, L)`` padded
        onto the prompt-length ladder, ``length`` int32 ``(1,)`` its
        real length. Returns the slot's initial state row(s)
        ``(1,) + state_shape`` and the first generated token ``(1,)``.
        When omitted, slots initialize to zero state and the prompt's
        last token (host-side, no prefill CachedOp).
    state_dtype : state tensor dtype (default float32).
    page_slots : int, optional
        Slots per state page (default ``MXNET_DECODE_PAGE_SLOTS``).
    max_tokens : int, optional
        Default generation cap per sequence (default
        ``MXNET_DECODE_MAX_TOKENS``); ``submit(max_tokens=)`` overrides.
    stop_token : int, optional
        Token id that terminates a sequence early.
    max_prompt_len : int
        Top of the prompt-length bucket ladder (default 64).
    prompt_buckets : sequence of int, optional
        Explicit prompt-length ladder (defaults to powers of two up to
        ``max_prompt_len``).
    """

    def __init__(self, step, *, state_shape, init=None,
                 state_dtype="float32", page_slots=None, max_tokens=None,
                 stop_token=None, max_prompt_len=64, prompt_buckets=None):
        from .. import env as _env
        from .buckets import BucketPolicy

        if not callable(step):
            raise ValueError("decode step must be callable, got %r"
                             % (step,))
        if init is not None and not callable(init):
            raise ValueError("decode init must be callable, got %r"
                             % (init,))
        shapes = tuple(state_shape)
        if not shapes:
            raise ValueError("state_shape must be non-empty")
        if all(isinstance(d, int) for d in shapes):
            self.state_shapes = (shapes,)
            self.single_state = True
        else:
            self.state_shapes = tuple(tuple(int(d) for d in s)
                                      for s in shapes)
            self.single_state = False
        self.step = step
        self.init = init
        self.state_dtype = np.dtype(state_dtype)
        self.page_slots = int(page_slots if page_slots is not None
                              else _env.get("MXNET_DECODE_PAGE_SLOTS"))
        if self.page_slots < 1:
            raise ValueError("page_slots must be >= 1, got %d"
                             % self.page_slots)
        self.max_tokens = int(max_tokens if max_tokens is not None
                              else _env.get("MXNET_DECODE_MAX_TOKENS"))
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1, got %d"
                             % self.max_tokens)
        self.stop_token = None if stop_token is None else int(stop_token)
        self.prompt_policy = BucketPolicy(max_batch=int(max_prompt_len),
                                          buckets=prompt_buckets)

    def describe(self):
        return {
            "state_shape": [list(s) for s in self.state_shapes],
            "state_dtype": str(self.state_dtype),
            "page_slots": self.page_slots,
            "max_tokens": self.max_tokens,
            "stop_token": self.stop_token,
            "prompt_buckets": list(self.prompt_policy.buckets),
            "prefill": self.init is not None,
        }


class PagedSlotAllocator:
    """Fixed-page batch-slot allocator: ``max_slots`` slots grouped into
    pages of ``page_slots``. ``alloc`` hands out the LOWEST free slot id
    (a heap free list) so occupancy stays prefix-compact — the stepped
    page-count tracks the real load down as sequences retire, not just
    up. No device memory here: slot ids index rows of the backend's
    pre-allocated page buffers, so admit/retire never allocates."""

    def __init__(self, max_slots, page_slots):
        self.max_slots = int(max_slots)
        self.page_slots = int(page_slots)
        if self.max_slots < 1 or self.page_slots < 1:
            raise ValueError("max_slots and page_slots must be >= 1")
        self.num_pages = -(-self.max_slots // self.page_slots)
        self._free = list(range(self.max_slots))
        heapq.heapify(self._free)
        self._used = set()

    def alloc(self):
        """Lowest free slot id, or None when exhausted."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._used.add(slot)
        return slot

    def free(self, slot):
        if slot not in self._used:
            raise ValueError("slot %r is not allocated" % (slot,))
        self._used.remove(slot)
        heapq.heappush(self._free, slot)

    @property
    def occupancy(self):
        return len(self._used)

    @property
    def high_water(self):
        """1 + highest occupied slot id (0 when empty) — the row count
        the next step must cover."""
        return max(self._used) + 1 if self._used else 0

    def pages_for(self, rows):
        """Pages covering the first ``rows`` slots."""
        return -(-int(rows) // self.page_slots)


class SequenceResult:
    """One sequence's outcome: the generated token ids plus the model
    generation that produced EVERY step of it (admission pins the
    generation; hot reload drains in-flight sequences before the swap
    applies, so a sequence never mixes weights)."""

    __slots__ = ("tokens", "model", "generation", "ttft_s")

    def __init__(self, tokens, model, generation, ttft_s):
        self.tokens = tokens
        self.model = model
        self.generation = generation
        self.ttft_s = ttft_s

    def __repr__(self):
        return ("SequenceResult(model=%r, generation=%d, tokens=%d, "
                "ttft_ms=%.2f)" % (self.model, self.generation,
                                   len(self.tokens), self.ttft_s * 1e3))


class _Sequence:
    __slots__ = ("prompt", "max_tokens", "deadline", "t_submit", "cls",
                 "future", "tokens", "slot", "generation", "t_first",
                 "ctx")

    def __init__(self, prompt, max_tokens, deadline, t_submit, cls):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.deadline = deadline
        self.t_submit = t_submit
        self.cls = cls
        self.future = Future()
        self.tokens = []
        self.slot = None
        self.generation = None
        self.t_first = None
        ctx = _xtrace.current()
        self.ctx = ctx if ctx is not None else _xtrace.new_root()


class _DecodeBackend:
    """Device half of the decode loop: the paged state tensors and the
    step, place and prefill CachedOps.

    ``compile_count`` counts the CachedOps' new signatures: one step per
    page count, one row placement per distinct state-row signature, one
    prefill per prompt bucket, the events the JAX package's trace counter
    counts. Flat after :meth:`warm` is the zero-retrace contract.

    Built by ``ModelSpec.build_backend`` for decode specs; a hot reload
    builds a FRESH backend (new params, new zeroed pages) and the loop
    swaps it only once in-flight sequences drain."""

    def __init__(self, config, params, name, policy, ctx=None):
        self.config = config
        self.name = name
        self.policy = policy
        self.ctx = ctx if ctx is not None else current_context()
        dev = self.ctx.torch_device
        self._params = [p.as_in_context(self.ctx) if isinstance(p, NDArray)
                        else nd.array(np.asarray(p), ctx=self.ctx)
                        for p in params]
        cfg = config
        ps = cfg.page_slots
        num_pages = -(-policy.max_batch // ps)
        dtype = torch_dtype(cfg.state_dtype)
        # All state allocated ONCE: per state tensor one buffer of
        # num_pages * page_slots rows, its pages ((page_slots,) +
        # state_shape) views of it. Slots index rows; admit writes a row
        # in place and retire leaves it dead until reuse.
        self._bufs = [torch.zeros((num_pages * ps,) + shape, dtype=dtype,
                                  device=dev) for shape in cfg.state_shapes]
        self.pages = [list(b.split(ps)) for b in self._bufs]
        n_par, n_st = len(self._params), len(cfg.state_shapes)
        ctx_ = self.ctx

        def step_fn(*args):
            state = args[n_par:n_par + n_st]
            tokens, pos, active = args[n_par + n_st:]
            st_in = state[0] if cfg.single_state else tuple(state)
            out_state, out_tok = cfg.step(*(list(args[:n_par])
                                            + [st_in, tokens, pos]))
            outs = (out_state,) if cfg.single_state else tuple(out_state)
            act = active._data
            for old, new in zip(state, outs):
                new = new._data if isinstance(new, NDArray) else new
                mask = act.reshape((-1,) + (1,) * (new.dim() - 1))
                # `old` is a view of the pages: the merge lands in place.
                old._data.copy_(torch.where(mask, new, old._data))
            tok = out_tok._data if isinstance(out_tok, NDArray) else out_tok
            return NDArray(torch.where(act, tok.to(torch.int32),
                                       tokens._data), ctx=ctx_)

        def place_fn(page, row, off):
            page._data[off].copy_(row._data)
            return page

        self._step = CachedOp(step_fn, num_params=n_par)
        self._place = CachedOp(place_fn)
        self._step.on_trace = lambda op: _trace.instant(
            "decode::trace", model=name)
        self._zero_rows = [nd.zeros(shape, ctx=self.ctx,
                                    dtype=cfg.state_dtype)
                           for shape in cfg.state_shapes]

        if cfg.init is not None:
            def prefill_fn(*args):
                out_state, first = cfg.init(*args)
                outs = (out_state,) if cfg.single_state else tuple(out_state)
                rows = tuple(NDArray((o._data if isinstance(o, NDArray)
                                      else o)[0], ctx=ctx_) for o in outs)
                f = first._data if isinstance(first, NDArray) else first
                return rows + (NDArray(f.to(torch.int32)[0], ctx=ctx_),)

            self._prefill = CachedOp(prefill_fn, num_params=n_par)
            self._prefill.on_trace = lambda op: _trace.instant(
                "decode::trace_prefill", model=name)
        else:
            self._prefill = None

    @property
    def compile_count(self):
        return self._step.num_traces + self._place.num_traces + (
            self._prefill.num_traces if self._prefill is not None else 0)

    @property
    def held_bytes(self):
        """Bytes of the params and the state pages."""
        return held_bytes(self._params + self._bufs)

    # -- hot path --------------------------------------------------------------

    def page_count(self, high_water):
        """Step signature for an occupancy: bucket the high-water slot
        onto the model ladder, then cover it in whole pages: churn
        inside a bucket reuses one signature."""
        bucket = self.policy.bucket_for(max(1, int(high_water)))
        return -(-bucket // self.config.page_slots)

    def step(self, n_pages, tokens, pos, active):
        """ONE decode iteration over the first ``n_pages`` pages; updates
        the state pages in place and returns the next token per covered
        slot (a host int32 array: the one host sync of an iteration,
        which every stop/deadline decision needs anyway)."""
        rows = n_pages * self.config.page_slots
        packed = torch.from_numpy(np.stack(
            [tokens[:rows], pos[:rows], active[:rows].astype(np.int32)]))
        packed = packed.to(self.ctx.torch_device)
        state = [NDArray(b[:rows], ctx=self.ctx) for b in self._bufs]
        next_tok = self._step.inference(
            *(self._params + state + [NDArray(packed[0], ctx=self.ctx),
                                      NDArray(packed[1], ctx=self.ctx),
                                      NDArray(packed[2] != 0,
                                              ctx=self.ctx)]))
        return next_tok._data.cpu().numpy()

    def _write_row(self, t, slot, row):
        page, off = divmod(int(slot), self.config.page_slots)
        self._place.inference(NDArray(self.pages[t][page], ctx=self.ctx),
                              row, off)

    def admit(self, slot, prompt):
        """Write one sequence's initial state into ``slot`` (the prefill
        when the config has ``init``, zero state and the last prompt
        token otherwise). Returns the slot's first token."""
        cfg = self.config
        if self._prefill is None:
            for t, zero in enumerate(self._zero_rows):
                self._write_row(t, slot, zero)
            return int(prompt[-1])
        plen = len(prompt)
        lbucket = cfg.prompt_policy.bucket_for(plen)
        padded = np.zeros((1, lbucket), np.int32)
        padded[0, :plen] = prompt
        *rows, first = self._prefill.inference(
            *(self._params + [nd.array(padded, ctx=self.ctx, dtype="int32"),
                              nd.array(np.asarray([plen], np.int32),
                                       ctx=self.ctx, dtype="int32")]))
        for t, row in enumerate(rows):
            self._write_row(t, slot, row)
        return int(first.asnumpy())

    def warm(self):
        """Run every signature the loop can dispatch: one step per ladder
        page count, the row placement per state tensor, and (with
        ``init``) one prefill per prompt-length bucket. After this the
        steady state adds none: the zero-retrace contract."""
        cfg = self.config
        ps = cfg.page_slots
        counts = sorted({-(-b // ps) for b in self.policy.buckets})
        top = counts[-1] * ps
        tokens = np.zeros(top, np.int32)
        pos = np.zeros(top, np.int32)
        active = np.zeros(top, bool)
        for n in counts:
            self.step(n, tokens, pos, active)
        for t, zero in enumerate(self._zero_rows):
            self._write_row(t, 0, zero)
        if self._prefill is not None:
            for lb in cfg.prompt_policy.buckets:
                self._prefill.inference(
                    *(self._params + [
                        nd.zeros((1, lb), ctx=self.ctx, dtype="int32"),
                        nd.array(np.asarray([1], np.int32), ctx=self.ctx,
                                 dtype="int32")]))
        return set(self.policy.buckets)


class DecodeLoop:
    """Iteration-level scheduler owning one decode model's device loop.

    A dedicated worker thread runs the Orca-style iteration: retire
    finished sequences, admit queued requests into freed slots, dispatch
    exactly one step. Thread model: ``pending``/lifecycle fields live
    under ``self._cond``; slot tables, host token/pos/active arrays and
    the backend are worker-private (no lock on the hot path).

    ``release=`` (the gateway seam) is called OUTSIDE the loop lock as
    ``release(n, depth)`` whenever ``n`` requests leave the pending
    queue (admitted, shed, or failed) leaving ``depth`` queued — the
    gateway's admission pool accounting; ``shed=`` as
    ``shed(seq, reason)`` when one is dropped.

    Hot reload: :meth:`swap_backend` parks admission, lets in-flight
    sequences finish on their admit-time generation, then swaps — the
    gateway's zero-drop reload contract at sequence granularity.
    """

    _SHED_GRACE = 10e-3

    def __init__(self, spec, backend, generation=1, *, release=None,
                 shed=None, idle_poll_ms=None, start=True):
        from .. import env as _env

        self.spec = spec
        self._backend = backend
        self._generation = int(generation)
        self._release = release
        self._shed = shed
        self._idle_poll = float(
            idle_poll_ms if idle_poll_ms is not None
            else _env.get("MXNET_DECODE_IDLE_POLL_MS")) / 1e3
        cfg = spec.decode
        slots = spec.policy.max_batch
        self.alloc = PagedSlotAllocator(slots, cfg.page_slots)
        self._tokens = np.zeros(slots, np.int32)
        self._pos = np.zeros(slots, np.int32)
        self._active = np.zeros(slots, bool)
        self._slots = {}              # slot id -> _Sequence (worker-only)
        self._cond = threading.Condition()
        self._pending = deque()
        self._pending_swap = None     # (backend, generation) | None
        self._running = False
        self._drain = True
        self._occupied = 0            # mirrored for cross-thread reads
        self._thread = None
        self._wd_lane = _watchdog.unique_lane("decode")
        self._occ_gauge = _dc_occupancy.labels(model=spec.name)
        self._tok_counter = _dc_tokens.labels(model=spec.name)
        self._step_counter = _dc_steps.labels(model=spec.name)
        self._ttft = _dc_ttft.labels(model=spec.name)
        self._occ_gauge.set(0)
        _dc_slots.labels(model=spec.name).set(self.alloc.max_slots)
        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        with self._cond:
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._run, name="mx-decode-%s" % self.spec.name,
                daemon=True)
            self._thread.start()
        return self

    def close(self, drain=True, timeout=None):
        """Stop the worker: with ``drain`` in-flight sequences finish
        first (pending ones fail either way). Joins the thread and
        releases the watchdog lane."""
        with self._cond:
            self._running = False
            self._drain = bool(drain)
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout if timeout is not None else 30)
        _watchdog.reset(self._wd_lane)

    # -- request path (any thread) ---------------------------------------------

    def submit(self, prompt, *, max_tokens=None, deadline=None,
               cls="default"):
        """Enqueue one sequence; returns its :class:`_Sequence` handle
        (``handle.future`` yields a :class:`SequenceResult`).
        ``deadline`` is an absolute ``time.perf_counter()`` instant
        covering the WHOLE sequence — a mid-decode deadline retires the
        slot and sheds."""
        cfg = self.spec.decode
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= cfg.prompt_policy.max_batch:
            raise ValueError(
                "prompt length must be in [1, %d], got %d"
                % (cfg.prompt_policy.max_batch, prompt.shape[0]))
        limit = cfg.max_tokens if max_tokens is None else int(max_tokens)
        if limit < 1:
            raise ValueError("max_tokens must be >= 1, got %d" % limit)
        seq = _Sequence(prompt, limit, deadline, time.perf_counter(), cls)
        with self._cond:
            if not self._running:
                raise ServiceUnavailableError(
                    "decode loop for model %r is closed" % self.spec.name)
            self._pending.append(seq)
            depth = len(self._pending)
            self._cond.notify_all()
        with _xtrace.activate(seq.ctx):
            _trace.instant("decode::enqueue", model=self.spec.name,
                           depth=depth)
        return seq

    @property
    def pending(self):
        with self._cond:
            return len(self._pending)

    @property
    def occupancy(self):
        return self._occupied      # racy read is fine: gauge-style

    def stats(self):
        return {
            "slots": self.alloc.max_slots,
            "page_slots": self.alloc.page_slots,
            "occupancy": self._occupied,
            "pending": self.pending,
            "generation": self._generation,
            "compile_count": self._backend.compile_count,
            "p99_ttft_ms": self._ttft.quantile(0.99) * 1e3,
        }

    # -- hot reload seam -------------------------------------------------------

    def swap_backend(self, backend, generation, drain_timeout=None):
        """Commit a new backend: admission parks (queued sequences stay
        queued), in-flight sequences finish on the OLD backend/
        generation, then the worker applies the swap and admission
        resumes. Blocks until applied or ``drain_timeout``; returns
        True when the old generation fully drained first."""
        from .. import env as _env

        if drain_timeout is None:
            drain_timeout = _env.get("MXNET_GATEWAY_DRAIN_TIMEOUT_S")
        with self._cond:
            self._pending_swap = (backend, int(generation))
            self._cond.notify_all()
            deadline = time.monotonic() + float(drain_timeout)
            while self._pending_swap is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(0.1, remaining))
            drained = self._pending_swap is None
            if not drained:
                # Timed out waiting for in-flight sequences: force the
                # swap for NEW admissions; live slots keep their state
                # pages on the old backend object until they retire.
                self._pending_swap = None
                self._backend, self._generation = backend, \
                    int(generation)
                self._cond.notify_all()
        return drained

    # -- worker ----------------------------------------------------------------

    def _released(self, n, depth):
        if self._release is not None and n:
            try:
                self._release(n, depth)
            except Exception as exc:
                _log.warn_rate_limited(
                    _logger, "decode_release", 60.0,
                    "decode release hook failed (gateway pool "
                    "accounting may drift): %s", exc)

    def _shed_one(self, seq, reason, exc):
        if seq.future.set_running_or_notify_cancel():
            seq.future.set_exception(exc)
        _xtrace.flag(seq.ctx, "decode_" + reason,
                     note="model=%s class=%s" % (self.spec.name, seq.cls))
        if self._shed is not None:
            try:
                self._shed(seq, reason)
            except Exception as exc2:
                _log.warn_rate_limited(
                    _logger, "decode_shed", 60.0,
                    "decode shed hook failed: %s", exc2)

    def _run(self):
        while True:
            with self._cond:
                while (self._running and not self._pending
                       and self._occupied == 0
                       and self._pending_swap is None):
                    self._cond.wait(self._idle_poll)
                running = self._running
                if not running and (not self._drain
                                    or self._occupied == 0):
                    break
                if self._pending_swap is not None \
                        and self._occupied == 0:
                    self._backend, self._generation = self._pending_swap
                    self._pending_swap = None
                    _trace.instant("decode::swap_commit",
                                   model=self.spec.name,
                                   generation=self._generation)
                    self._cond.notify_all()
                swapping = self._pending_swap is not None
                now = time.perf_counter()
                shed, admits = [], []
                keep = deque()
                while self._pending:
                    seq = self._pending.popleft()
                    if seq.future.cancelled():
                        shed.append((seq, None))
                    elif seq.deadline is not None \
                            and now > seq.deadline + self._SHED_GRACE:
                        shed.append((seq, "deadline"))
                    else:
                        keep.append(seq)
                self._pending = keep
                if running and not swapping:
                    while self._pending and self.alloc.occupancy \
                            + len(admits) < self.alloc.max_slots:
                        admits.append(self._pending.popleft())
                depth = len(self._pending)
            released = len(shed) + len(admits)
            for seq, reason in shed:
                if reason is None:
                    continue
                self._shed_one(seq, "deadline", DeadlineExceededError(
                    "sequence expired after %.1f ms in decode queue"
                    % ((now - seq.t_submit) * 1e3)))
            self._released(released, depth)
            if admits:
                self._admit(admits)
            if self._occupied:
                self._step_once()
        self._fail_remaining()

    def _admit(self, admits):
        backend, gen = self._backend, self._generation
        cfg = self.spec.decode
        finished = []
        with _trace.span("decode::admit", model=self.spec.name,
                         n=len(admits)):
            for seq in admits:
                slot = self.alloc.alloc()
                assert slot is not None, "admitted past slot capacity"
                first = backend.admit(slot, seq.prompt)
                seq.slot = slot
                seq.generation = gen
                self._slots[slot] = seq
                self._tokens[slot] = first
                self._pos[slot] = len(seq.prompt)
                self._active[slot] = True
                if backend._prefill is not None:
                    # Prefill EMITS the first token: TTFT stops here.
                    seq.tokens.append(first)
                    seq.t_first = time.perf_counter()
                    self._ttft.observe(seq.t_first - seq.t_submit)
                    self._tok_counter.inc()
                    if (cfg.stop_token is not None
                            and first == cfg.stop_token) \
                            or len(seq.tokens) >= seq.max_tokens:
                        finished.append((seq, None))
                with _xtrace.activate(seq.ctx):
                    _trace.instant("decode::slot_admit",
                                   model=self.spec.name, slot=slot,
                                   generation=gen)
        if finished:
            self._retire(finished, time.perf_counter())
        else:
            self._set_occupied()

    def _set_occupied(self):
        with self._cond:
            self._occupied = self.alloc.occupancy
            self._cond.notify_all()
        self._occ_gauge.set(self.alloc.occupancy)

    def _step_once(self):
        backend = self._backend
        cfg = self.spec.decode
        n_pages = backend.page_count(self.alloc.high_water)
        rows = n_pages * cfg.page_slots
        oldest = min(self._slots.values(), key=lambda s: s.t_submit)
        _watchdog.begin(self._wd_lane)
        try:
            with _xtrace.activate(oldest.ctx), \
                    _trace.span("decode::step", model=self.spec.name,
                                pages=n_pages, rows=rows,
                                occupancy=self.alloc.occupancy,
                                generation=self._generation):
                next_tok = backend.step(n_pages, self._tokens,
                                        self._pos, self._active)
        finally:
            _watchdog.end(self._wd_lane)
        self._step_counter.inc()
        self._tok_counter.inc(len(self._slots))
        now = time.perf_counter()
        finished = []
        toks = next_tok.tolist()    # one host conversion, not per-slot
        for slot, seq in self._slots.items():
            tok = toks[slot]
            seq.tokens.append(tok)
            self._tokens[slot] = tok
            self._pos[slot] += 1
            if seq.t_first is None:
                seq.t_first = now
                self._ttft.observe(now - seq.t_submit)
            if seq.deadline is not None and now > seq.deadline:
                finished.append((seq, "deadline"))
            elif (cfg.stop_token is not None
                    and tok == cfg.stop_token) \
                    or len(seq.tokens) >= seq.max_tokens:
                finished.append((seq, None))
        if finished:
            self._retire(finished, now)

    def _retire(self, finished, now):
        with _trace.span("decode::retire", model=self.spec.name,
                         n=len(finished)):
            for seq, reason in finished:
                self.alloc.free(seq.slot)
                self._active[seq.slot] = False
                del self._slots[seq.slot]
                with _xtrace.activate(seq.ctx):
                    _trace.complete("decode::sequence", seq.t_submit,
                                    now, model=self.spec.name,
                                    slot=seq.slot, tokens=len(seq.tokens),
                                    generation=seq.generation)
                if reason is not None:
                    self._shed_one(seq, reason, DeadlineExceededError(
                        "sequence deadline exceeded mid-decode after "
                        "%d tokens" % len(seq.tokens)))
                elif seq.future.set_running_or_notify_cancel():
                    seq.future.set_result(SequenceResult(
                        list(seq.tokens), self.spec.name, seq.generation,
                        (seq.t_first - seq.t_submit)
                        if seq.t_first is not None else 0.0))
        self._set_occupied()

    def _fail_remaining(self):
        """Worker exit (close without drain, or drain complete): fail
        whatever is still queued or in a slot — nothing silently hangs."""
        with self._cond:
            rest = list(self._pending)
            self._pending.clear()
        dropped = list(self._slots.values())
        for seq in dropped:
            self.alloc.free(seq.slot)
            self._active[seq.slot] = False
        self._slots.clear()
        self._set_occupied()
        for seq in rest + dropped:
            self._shed_one(seq, "closed", ServiceUnavailableError(
                "decode loop for model %r shut down" % self.spec.name))
        self._released(len(rest), 0)
