"""InferenceServer — the serving frontend over a CachedOp.

Counterpart of ``mxnet_tpu/serving/engine.py``. Each bucket size is one
input signature of the served function's CachedOp; ``warmup()`` runs
every bucket once, so no request pays a new signature's first-call cost.
After warmup the steady state is:

    submit() -> bounded queue -> worker coalesces a bucket ->
    pad -> ONE device call -> unpad/slice -> resolve futures

Request contract: every request carries an explicit batch dim, shape
``(k, *item_shape)`` with ``1 <= k <= max_batch``, and results keep it.
Requests are host arrays (numpy or NDArray) in ``dtype``; the worker
assembles the padded batch on the host and uploads it once per device
call. numpy has no bfloat16, so a bfloat16 model takes float32 requests
and casts on the card inside the served function.

``from_checkpoint`` serves a ``prefix-symbol.json`` +
``prefix-%04d.params`` pair through one eval-mode Executor per bucket
shape, the parameters shared by all of them; with
``MXNET_SUBGRAPH_BACKEND`` naming a registered backend, each Executor
partitions the graph at bind.

Left for later slices: the telemetry hooks of the JAX package (trace
spans, watchdog lane, readiness slot).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import ndarray as nd
from ..cached_op import CachedOp
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .admission import AdmissionController
from .batcher import DynamicBatcher
from .buckets import BucketPolicy
from .metrics import ServingMetrics

__all__ = ["InferenceServer"]


class _FnModel:
    """A pure ``fn(*params, data)`` wrapped into an eval-mode CachedOp:
    no train-mode ops, one signature per bucket shape."""

    def __init__(self, fn, params, ctx):
        self._params = [p if isinstance(p, NDArray) else nd.array(p, ctx=ctx)
                        for p in params]
        self._cached = CachedOp(fn, num_params=len(self._params))

    def __call__(self, batch):
        return self._cached.inference(*(self._params + [batch]))

    @property
    def compile_count(self):
        return self._cached.num_traces


class _CheckpointModel:
    """A ``model.load_checkpoint`` artifact served through one eval-mode
    Executor per bucket shape. The parameters are moved to `ctx` once and
    bound by reference into every Executor; each gets its own data array
    (and zero arrays for other unfed inputs, such as a loss head's
    label)."""

    def __init__(self, symbol, arg_params, aux_params, ctx,
                 data_name="data"):
        self._symbol = symbol
        self._ctx = ctx
        self._arg_params = {k: v.as_in_context(ctx)
                            for k, v in arg_params.items()}
        self._aux_params = {k: v.as_in_context(ctx)
                            for k, v in (aux_params or {}).items()}
        self._data_name = data_name
        self._executors = {}  # batch shape -> Executor

    def _executor_for(self, shape):
        ex = self._executors.get(shape)
        if ex is None:
            sym = self._symbol
            known = {n: v.shape for n, v in self._arg_params.items()}
            known.update((n, v.shape) for n, v in self._aux_params.items())
            known[self._data_name] = shape
            arg_shapes, _, aux_shapes = sym.infer_shape(**known)
            args = {n: self._arg_params[n] if n in self._arg_params
                    else nd.zeros(s, ctx=self._ctx)
                    for n, s in zip(sym.list_arguments(), arg_shapes)}
            aux = {n: self._aux_params[n] if n in self._aux_params
                   else nd.zeros(s, ctx=self._ctx)
                   for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
            ex = sym.bind(self._ctx, args=args, aux_states=aux,
                          grad_req="null")
            self._executors[shape] = ex
        return ex

    def __call__(self, batch):
        ex = self._executor_for(tuple(batch.shape))
        with torch.no_grad():
            outs = ex.forward(is_train=False, **{self._data_name: batch})
        return outs[0] if len(outs) == 1 else tuple(outs)

    @property
    def compile_count(self):
        """Bucket executors that have run a forward (a snapshot: the
        worker may be adding one)."""
        return sum(1 for ex in list(self._executors.values())
                   if ex.num_forwards)


class InferenceServer:
    """Shape-bucketed batching inference server.

    Parameters
    ----------
    fn : callable(*params, data), optional
        Pure eval-time forward over NDArrays. Exactly one of `fn` and
        `model` (see :meth:`from_checkpoint`).
    params : sequence of NDArray/ndarray
        Leading arguments bound to `fn`.
    item_shape : tuple
        Per-example shape, without the batch dim.
    dtype : request dtype (default float32; a numpy dtype).
    max_batch, buckets : bucket ladder (BucketPolicy).
    max_delay_ms : float
        Batching window: the longest a request waits for co-batching.
    max_queue : int
        Bounded-queue admission limit (QueueFullError beyond it).
    timeout_ms : float, optional
        Default per-request deadline; expired queued requests are shed
        with DeadlineExceededError.
    ctx : Context the batches run on (default: the caller's current
        context, ``gpu(0)`` unless the caller chose another).
    warmup : run every bucket once at construction (default True).
    start : start the worker thread at construction (default True).
    model : callable(batch NDArray) with a ``compile_count``, optional
        A prepared model, such as the checkpoint model of
        :meth:`from_checkpoint`.
    """

    def __init__(self, fn=None, params=(), *, item_shape, dtype="float32",
                 max_batch=32, buckets=None, max_delay_ms=5.0,
                 max_queue=128, timeout_ms=None, ctx=None, warmup=True,
                 start=True, model=None):
        if (fn is None) == (model is None):
            raise ValueError("pass exactly one of fn= or model=")
        self._ctx = ctx if ctx is not None else current_context()
        self._model = model if model is not None else \
            _FnModel(fn, params, self._ctx)
        self._item_shape = tuple(item_shape)
        self._dtype = np.dtype(dtype)
        self.policy = BucketPolicy(max_batch=max_batch, buckets=buckets)
        self.metrics = ServingMetrics()
        self._warmed = set()
        # Serializes device calls: warmup() on a started server must not
        # race the worker.
        self._model_lock = threading.Lock()
        self._batcher = DynamicBatcher(
            self._run_batch, self.policy,
            AdmissionController(max_queue=max_queue,
                                default_timeout_ms=timeout_ms),
            self.metrics, max_delay_ms=max_delay_ms)
        if warmup:
            self.warmup()
        if start:
            self._batcher.start()

    @classmethod
    def from_checkpoint(cls, prefix, epoch, *, item_shape, data_name="data",
                        **kwargs):
        """Serve a ``model.save_checkpoint`` / ``HybridBlock.export``
        artifact (``prefix-symbol.json`` + ``prefix-%04d.params``) on
        ``kwargs["ctx"]`` (default: the current context)."""
        from .. import model as _model

        ctx = kwargs.get("ctx")
        ctx = ctx if ctx is not None else current_context()
        symbol, arg_params, aux_params = _model.load_checkpoint(
            prefix, epoch, ctx=ctx)
        kwargs["ctx"] = ctx
        return cls(model=_CheckpointModel(symbol, arg_params, aux_params,
                                          ctx, data_name=data_name),
                   item_shape=item_shape, **kwargs)

    # -- lifecycle ------------------------------------------------------------

    def warmup(self, buckets=None):
        """Run one dummy batch of each bucket shape. Idempotent."""
        for b in (buckets if buckets is not None else self.policy.buckets):
            with self._model_lock:
                if b in self._warmed:
                    continue
                batch = nd.array(np.zeros((b,) + self._item_shape,
                                          self._dtype), ctx=self._ctx)
                out = self._model(batch)
                for o in (out if isinstance(out, tuple) else (out,)):
                    o.wait_to_read()
                self._warmed.add(b)
        return self

    def start(self):
        self._batcher.start()
        return self

    def pause(self):
        """Suspend dispatch (submits still queue)."""
        self._batcher.pause()
        return self

    def resume(self):
        self._batcher.resume()
        return self

    def shutdown(self, drain=True, timeout=None):
        self._batcher.shutdown(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- request path ---------------------------------------------------------

    def submit(self, data, timeout_ms=None):
        """Enqueue one request; returns a `concurrent.futures.Future`
        yielding the output rows for this request (batch dim kept; a
        multi-output function yields a tuple)."""
        # Snapshot the request: the worker reads it up to a delay window
        # later, so it must not alias a buffer the caller reuses.
        arr = data.asnumpy() if isinstance(data, NDArray) \
            else np.array(data, dtype=self._dtype)
        if tuple(arr.shape[1:]) != self._item_shape:
            raise ValueError(
                "request shape %r does not match (k,) + item_shape %r"
                % (tuple(arr.shape), self._item_shape))
        rows = int(arr.shape[0])
        if not 1 <= rows <= self.policy.max_batch:
            raise ValueError("request rows must be in [1, %d], got %d"
                             % (self.policy.max_batch, rows))
        return self._batcher.submit(arr.astype(self._dtype, copy=False),
                                    rows, timeout_ms=timeout_ms)

    def predict(self, data, timeout_ms=None):
        """Synchronous submit: block until the batched result arrives."""
        return self.submit(data, timeout_ms=timeout_ms).result()

    @property
    def compile_count(self):
        """Input signatures the served function has run (one per warmed
        bucket)."""
        return self._model.compile_count

    def stats(self):
        return self.metrics.snapshot()

    # -- worker side ----------------------------------------------------------

    def _run_batch(self, requests, bucket):
        """Assemble and pad the bucket batch, ONE device call, unpad per
        request. Runs on the batcher's worker thread."""
        t0 = time.perf_counter()
        batch = np.zeros((bucket,) + self._item_shape, self._dtype)
        spans, off = [], 0
        for req in requests:
            batch[off:off + req.rows] = req.data
            spans.append((req, off, off + req.rows))
            off += req.rows
        with self._model_lock:
            out = self._model(nd.array(batch, ctx=self._ctx))
            outs = out if isinstance(out, tuple) else (out,)
            for o in outs:
                o.wait_to_read()  # latency truth under async dispatch
        self.metrics.record_batch(bucket, off, len(requests),
                                  time.perf_counter() - t0)
        done = time.perf_counter()
        for req, i0, i1 in spans:
            sliced = tuple(o[i0:i1] for o in outs)
            self.metrics.record_request_latency(bucket, done - req.t_submit)
            req.future.set_result(sliced if len(sliced) > 1 else sliced[0])
