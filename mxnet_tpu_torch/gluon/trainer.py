"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py — Trainer, _init_kvstore, step/
allreduce_grads/update, the update_on_kvstore logic, save_states/
load_states): the usual MXNet training loop ::

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` rescales by ``1/batch_size`` and applies the optimizer once per
parameter. With ``fused=True`` (the default, ``MXNET_FUSED_UPDATE``) the
parameters of a supported family go through
:class:`~mxnet_tpu_torch.fused_update.FusedApplier`: one pass per
~25 MB chunk, updated in place and bit-identical to the per-parameter
loop that ``fused=False`` runs (the reference-shaped
``Updater(index, grad, weight)`` call per parameter).

Parameters on several contexts (``initialize(ctx=[...])`` with
``gluon.utils.split_and_load``) and ``dist_*`` stores take the JAX
package's data-parallel path (``trainer.py:192-591`` there):

- the store is created at the first step, after ``rescale_grad`` is
  final (a dist store pickles the optimizer to its servers then);
- ``update_on_kvstore`` defaults to True for a dist store (the server
  runs the optimizer) and False for a local one; ``dist_async`` needs
  it True;
- ``allreduce_grads`` reduces through the store in flat buckets
  (``fused_update.GradBucketer``), and the update runs once on the
  first context and is copied to the others;
- the fused step overlaps the reduce of bucket i+1 with the apply of
  bucket i on a comm thread (``MXNET_FUSED_OVERLAP_DEPTH``, default 2;
  0 is the serial order, bit for bit the same);
- update-on-kvstore over a fused-eligible optimizer moves flat weight
  buckets; gradient compression goes through the store.

One context with a local store creates no store (as in the JAX
package). ``telemetry.NumericGuard(...).install(trainer._applier)``
checks every fused step's updated weights (one read per step, the
overlapped path's buckets included).

A parameter with ``grad_stype="row_sparse"`` (``Embedding(...,
sparse_grad=True)``) stays out of the fused chunks and the flat
buckets: its dense gradient is turned row-sparse (on its device with
``fused``, ``sparse.dense_to_rsp_device``; through the host without)
and the optimizer's lazy row-sparse update runs for it alone. A global
norm clip then raises ``ValueError``, as in the JAX package.
"""
from __future__ import annotations

import math
import queue
import threading
import time

import torch

from .. import env as _env
from .. import optimizer as opt
from .. import profiler as _profiler
from ..checkpoint import guard as _guard
from ..ndarray import sparse as _sp
from ..ops import optimizer_ops as _oo
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import xtrace as _xtrace
from .parameter import ParameterDict

__all__ = ["Trainer"]

_update_seconds = _tm.REGISTRY.histogram(
    "mx_trainer_update_seconds",
    "Trainer._update wall time (host dispatch path, fused or loop; on "
    "the overlapped path this covers the whole reduce+apply pipeline)")
_reduce_seconds = _tm.REGISTRY.counter(
    "mx_trainer_reduce_seconds_total",
    "Gradient-reduce (kvstore push+pull) busy seconds on the fused "
    "bucketed path")
_reduce_hidden_seconds = _tm.REGISTRY.counter(
    "mx_trainer_reduce_hidden_seconds_total",
    "Reduce seconds hidden behind compute by the overlapped "
    "reduce->apply pipeline (busy - exposed main-thread wait)")
_overlap_efficiency = _tm.REGISTRY.gauge(
    "mx_trainer_overlap_efficiency",
    "Per-step overlap efficiency of the fused bucketed step: reduce "
    "time hidden / total reduce time (0 = fully serial)")


def _gn_sumsq(grad):
    """fp32 sum of squares of one gradient tensor (the per-param half
    of the global-norm clip; low-precision grads widen first)."""
    g32 = grad if grad.dtype == torch.float32 else grad.to(torch.float32)
    return (g32 * g32).sum()


def overlap_depth():
    """Comm/compute overlap window (``MXNET_FUSED_OVERLAP_DEPTH``,
    default 2): how many gradient buckets may be reducing ahead of
    their fused applies; 0 is the serial reduce-then-apply step. Read
    per step."""
    return int(_env.get("MXNET_FUSED_OVERLAP_DEPTH"))


class _ReduceTask:
    """One bucket's reduce in flight: push + async pull issued on the
    Trainer's comm thread (or inline when serial), drained by the main
    thread in submission order."""

    __slots__ = ("key", "flats", "register", "event", "error", "handle",
                 "seconds", "inline_pull", "kv", "ctx")

    def __init__(self, key, flats, register=None, kv=None):
        self.key = key
        self.flats = flats
        self.register = register
        self.event = threading.Event()
        self.error = None
        self.handle = None
        self.seconds = 0.0
        self.inline_pull = False
        self.kv = kv
        # The step's trace context, captured on the stepping thread and
        # re-activated on the comm thread.
        self.ctx = _xtrace.current()

    def run(self, kv):
        t0 = time.perf_counter()
        try:
            with _xtrace.activate(self.ctx), \
                    _trace.span("trainer::allreduce", key=self.key,
                                overlapped=True):
                if self.register is not None:
                    self.register()
                kv.push(self.key, self.flats)
                self.handle = kv.pull_async(self.key, self.flats)
                # Local stores complete the pull inside pull_async
                # (handle.inline); counting its seconds again would
                # double-bill.
                self.inline_pull = self.handle.inline
        except BaseException as exc:      # noqa: BLE001 — relayed
            self.error = exc
        self.seconds = time.perf_counter() - t0
        self.event.set()

    def wait(self):
        """Block until push+pull landed; re-raise any transport error."""
        self.event.wait()
        if self.error is not None:
            raise self.error
        self.handle.wait()

    @property
    def comm_seconds(self):
        """Busy seconds this bucket spent in the store (push + pull)."""
        extra = 0.0 if (self.handle is None or self.inline_pull) \
            else self.handle.seconds
        return self.seconds + extra


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    gluon/trainer.py:Trainer).

    Parameters
    ----------
    params : ParameterDict, dict or list of Parameters (on one context
        or on several).
    optimizer : name or :class:`~mxnet_tpu_torch.optimizer.Optimizer`.
    optimizer_params : dict of the optimizer's keyword arguments.
    kvstore : ``"device"``/``"local"``/``"dist_*"``/None or a KVStore;
        with one context and a local store no store is created (as in
        the JAX package).
    compression_params : gradient compression of the store
        (``{"type": "2bit", "threshold": t}``).
    update_on_kvstore : None (default: True for a dist store), True or
        False; True needs a store (several contexts or ``dist_*``).
    fused : multi-tensor apply (default ``MXNET_FUSED_UPDATE``, on).
    global_norm_clip : clip the summed, pre-rescale gradients to this
        global L2 norm (``gluon.utils.clip_global_norm`` semantics).
    """

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fused=None, global_norm_clip=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict, dict or list")
        self._params = list(params)
        self._compression_params = compression_params
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._fused = bool(_env.get("MXNET_FUSED_UPDATE")) \
            if fused is None else bool(fused)
        from .. import fused_update as _fu

        self._applier = _fu.FusedApplier(self._updater)
        # One stable merge buffer per parameter for the store-less
        # multi-context path keeps the applier's identity-keyed plan
        # cache hot across steps.
        self._merge_bufs = {}
        self._bucketer = None
        self._bucketer_sig = None
        self._bucket_plan = None
        self._bucket_gen = -1
        self._bucket_keys_inited = set()
        self._global_norm_clip = (None if global_norm_clip is None
                                  else float(global_norm_clip))
        if self._global_norm_clip is not None and \
                self._global_norm_clip <= 0:
            raise ValueError("global_norm_clip must be positive")
        self._comm_q = None
        self._comm_thread = None
        self._uokv_bucketed = None     # update_on_kvstore bucket plan
        self._uokv_wbufs = {}          # bucket.id -> per-device flats

    def _check_contexts(self):
        contexts = None
        for p in self._params:
            if p._data is None:
                continue
            ctx = p.list_ctx()
            if contexts is None:
                contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError(
                    "optimizer_params must be empty when optimizer is an "
                    "instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        self._updater.state_ctx = self._state_ctx

    def _state_ctx(self, index):
        p = self._params[index] if isinstance(index, int) and \
            0 <= index < len(self._params) else None
        return p.list_ctx()[0] if p is not None and p._data is not None \
            else None

    def _init_kvstore(self):
        """Create the store at the first step (reference
        trainer.py:_init_kvstore): for several contexts, and for every
        ``dist_*`` store (the sync is across processes)."""
        contexts = self._check_contexts()
        kv_type = self._kvstore_type
        name = kv_type.type if hasattr(kv_type, "type") \
            else str(kv_type or "")
        dist = "dist" in name
        if (len(contexts) > 1 or dist) and kv_type:
            from .. import kvstore as kvs

            self._kvstore = kv_type if isinstance(kv_type, kvs.KVStore) \
                else kvs.create(name)
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = dist
            if self._update_on_kvstore and \
                    self._global_norm_clip is not None:
                # The server applies per key as pushes arrive: no worker
                # holds the whole summed gradient to take its norm.
                raise ValueError("global_norm_clip is not supported "
                                 "with update_on_kvstore")
            if dist and "async" in name and not self._update_on_kvstore:
                # Async pushes apply on the server at once; without the
                # optimizer there it would assign raw gradients.
                raise ValueError(
                    "Please set update_on_kvstore=True for dist_async")
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            self._uokv_bucketed = (self._update_on_kvstore
                                   and self._uokv_eligible())
            skip = set()
            if self._uokv_bucketed:
                # The server stores (and updates) one flat weight vector
                # per bucket; per-param keys only for the leftovers.
                bucketer, bucket_params, _odd = self._ensure_bucketer()
                for b in bucketer.buckets:
                    skip.update(b.keys)
                self._init_uokv_buckets(bucketer, bucket_params)
            for i, p in enumerate(self._params):
                if p.grad_req != "null" and i not in skip:
                    self._kvstore.init(i, p.data())
        else:
            if self._update_on_kvstore:
                raise ValueError(
                    "update_on_kvstore=True requires a kvstore (multi-"
                    "context or dist_*); this trainer has %d context(s) "
                    "and kvstore=%r" % (len(contexts), self._kvstore_type))
            self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr_scheduler(self._optimizer.num_update) \
            if self._optimizer.lr_scheduler else self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce_grads + update (reference: trainer.py:step).

        ``ignore_stale_grad`` is accepted and, as in the JAX package,
        changes nothing: no gradient freshness is tracked."""
        _profiler.step_boundary()
        ctx = _xtrace.current()
        with _xtrace.activate(ctx if ctx is not None
                              else _xtrace.new_root()):
            self._step_traced(batch_size, ignore_stale_grad)

    def _step_traced(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            # After rescale_grad is final: a dist store pickles the
            # optimizer to its servers here.
            self._init_kvstore()
        if self._update_on_kvstore:
            if self._uokv_bucketed:
                self._step_on_kvstore_bucketed()
                return
            # Optimizer on the server: push every gradient, then pull
            # every weight (reference _update_params_on_kvstore order).
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.push(i, p.list_grad())
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.pull(i, out=p.list_data())
            return
        depth = overlap_depth() if self._fused else 0
        if self._kvstore is not None and self._fused and \
                (depth > 0 or self._global_norm_clip is not None):
            self._step_pipelined(depth, ignore_stale_grad)
            return
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce the gradients across contexts (and processes) through
        the store; nothing to do on one context."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not self._update_on_kvstore, \
            "allreduce_grads is not supported with update_on_kvstore"
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        if not self._fused:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    grads = p.list_grad()
                    self._kvstore.push(i, grads)
                    self._kvstore.pull(i, grads)
            return
        # Bucketed: traffic and passes scale with ceil(params/bucket).
        # The flat sum is element for element the per-key merge's add
        # chain, so the merged gradients are the same bits.
        bucketer, bucket_params, odd = self._ensure_bucketer()
        with _trace.span("trainer::allreduce", buckets=len(bucketer),
                         unbucketed=len(odd)):
            for bucket in bucketer.buckets:
                dev_grads = [list(p._grad.values())
                             for p in bucket_params[bucket.id]]
                flats = [bucket.flatten([g[d] for g in dev_grads],
                                        dev_grads[0][d].context)
                         for d in range(len(dev_grads[0]))]
                self._register_bucket_key(bucket, flats)
                self._kvstore.push(bucket.store_key, flats)
                self._kvstore.pull(bucket.store_key, flats)
                for d, flat in enumerate(flats):
                    for grads, piece in zip(dev_grads,
                                            bucket.unflatten(flat)):
                        grads[d]._set_data(piece)
            for i in odd:
                grads = self._params[i].list_grad()
                self._kvstore.push(i, grads)
                self._kvstore.pull(i, grads)

    def _ensure_bucketer(self):
        """The coalescing plan for the current gradient set, rebuilt only
        when the parameters or their gradient dicts change; each rebuild
        takes fresh store keys and retires the old generation's."""
        from .. import fused_update as _fu

        plan = self._bucket_plan
        if plan is not None:
            p_snap, g_snap, result = plan
            if len(p_snap) == len(self._params) and \
                    all(a is b for a, b in zip(p_snap, self._params)) and \
                    all(p._grad is g for p, g in zip(p_snap, g_snap)):
                return result
        entries, odd, sig = [], [], []
        first_ctx = None
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            grad = p.list_grad()[0]
            ctxs = tuple(str(c) for c in p.list_ctx())
            if first_ctx is None:
                first_ctx = ctxs
            if p._grad_stype != "default" or ctxs != first_ctx:
                # Row-sparse parameters and odd device layouts keep the
                # per-key path.
                odd.append(i)
                continue
            entries.append((i, grad.shape, grad._data.dtype))
            sig.append((i, tuple(grad.shape), str(grad._data.dtype)))
        sig = tuple(sig)
        if self._bucketer is None or self._bucketer_sig != sig:
            self._bucket_gen += 1
            if self._kvstore is not None:
                for key in self._bucket_keys_inited:
                    self._kvstore.discard(key)
            self._bucketer = _fu.GradBucketer(entries)
            self._bucketer_sig = sig
            self._bucket_keys_inited = set()
            for b in self._bucketer.buckets:
                b.store_key = "__fused_grad_bucket_%d_%d" % (
                    self._bucket_gen, b.id)
        bucket_params = {b.id: [self._params[i] for i in b.keys]
                         for b in self._bucketer.buckets}
        result = (self._bucketer, bucket_params, odd)
        self._bucket_plan = (tuple(self._params),
                             tuple(p._grad for p in self._params), result)
        return result

    # -- optimizer on the server over flat buckets -----------------------------

    def _uokv_eligible(self):
        """Bucketed update_on_kvstore is safe when the family is
        elementwise (the fused-apply table) and no per-key lr/wd
        multipliers exist (a flat bucket has one server key)."""
        if not self._fused:
            return False
        from .. import fused_update as _fu

        if _fu._spec_for(self._optimizer) is None:
            return False
        if getattr(self._optimizer, "multi_precision", False):
            return False
        if self._optimizer.lr_mult or self._optimizer.wd_mult:
            return False
        return all(getattr(p, "lr_mult", 1.0) == 1.0 and
                   getattr(p, "wd_mult", 1.0) == 1.0
                   for p in self._params)

    def _init_uokv_buckets(self, bucketer, bucket_params):
        """Seed the store with one flat weight vector per bucket."""
        for b in bucketer.buckets:
            weights = [list(p._data.values())[0]
                       for p in bucket_params[b.id]]
            wflat = b.flatten(weights, weights[0].context)
            if not self._kvstore.contains(b.store_key):
                self._kvstore.init(b.store_key, wflat)
            self._bucket_keys_inited.add(b.store_key)

    def _step_on_kvstore_bucketed(self):
        """Optimizer on the server over buckets: push the flat gradient
        buckets, pull the flat weight buckets back, slice the weights out
        per parameter."""
        t0 = time.perf_counter()
        bucketer, bucket_params, odd = self._ensure_bucketer()
        kv = self._kvstore
        if not all(b.store_key in self._bucket_keys_inited
                   for b in bucketer.buckets):
            self._uokv_wbufs = {}
            self._init_uokv_buckets(bucketer, bucket_params)
        with _trace.span("trainer::allreduce", buckets=len(bucketer),
                         unbucketed=len(odd), on_kvstore=True), \
                _guard.updating():
            for bucket in bucketer.buckets:
                dev_grads = [list(p._grad.values())
                             for p in bucket_params[bucket.id]]
                flats = [bucket.flatten([g[d] for g in dev_grads],
                                        dev_grads[0][d].context)
                         for d in range(len(dev_grads[0]))]
                kv.push(bucket.store_key, flats)
            for i in odd:
                kv.push(i, self._params[i].list_grad())
            for bucket in bucketer.buckets:
                dev_datas = [list(p._data.values())
                             for p in bucket_params[bucket.id]]
                wbufs = self._uokv_wbufs.get(bucket.id)
                if wbufs is None:
                    wbufs = [bucket.flatten([d[dd] for d in dev_datas],
                                            dev_datas[0][dd].context)
                             for dd in range(len(dev_datas[0]))]
                    self._uokv_wbufs[bucket.id] = wbufs
                kv.pull(bucket.store_key, out=wbufs)
                for dd, wflat in enumerate(wbufs):
                    for datas, piece in zip(dev_datas,
                                            bucket.unflatten(wflat)):
                        datas[dd]._set_data(piece)
            for i in odd:
                kv.pull(i, out=self._params[i].list_data())
        _update_seconds.observe(time.perf_counter() - t0)

    # -- overlapped reduce->apply pipeline ------------------------------------

    def _ensure_comm_thread(self):
        if self._comm_thread is None:
            import weakref

            q = self._comm_q = queue.Queue()

            def loop():
                # Holds only the queue: the thread must not pin the
                # Trainer; the finalizer posts the sentinel at GC.
                while True:
                    task = q.get()
                    if task is None:
                        return
                    task.run(task.kv)
                    task = None

            self._comm_thread = threading.Thread(
                target=loop, name="mx-trainer-comm", daemon=True)
            self._comm_thread.start()
            fin = weakref.finalize(self, q.put, None)
            fin.atexit = False

    def _register_bucket_key(self, bucket, flats):
        """Lazy store registration of one bucket key."""
        key = bucket.store_key
        if key not in self._bucket_keys_inited:
            if not self._kvstore.contains(key):
                self._kvstore.init(key, flats[0])
            self._bucket_keys_inited.add(key)

    def _step_pipelined(self, depth, ignore_stale_grad=False):
        """The overlapped fused step: buckets reduce in reverse parameter
        order through the comm thread and async pulls, and each bucket's
        fused apply runs as soon as its pull lands, while up to `depth`
        later buckets still reduce. ``depth == 0`` runs the same
        per-bucket math serially (the same bits)."""
        t0 = time.perf_counter()
        bucketer, bucket_params, odd = self._ensure_bucketer()
        clip = self._global_norm_clip
        if clip is not None and any(
                p._grad_stype != "default" for p in self._params
                if p._grad_req != "null" and p._data is not None):
            raise ValueError("global_norm_clip requires dense gradients")
        serial = depth <= 0
        if not serial:
            self._ensure_comm_thread()
        buckets = list(reversed(bucketer.buckets))
        stats = {"wait": 0.0, "comm": 0.0}
        in_flight = []                   # (bucket, task, dev_grads)
        next_i = [0]

        def submit_one():
            if next_i[0] >= len(buckets):
                return False
            bucket = buckets[next_i[0]]
            next_i[0] += 1
            dev_grads = [list(p._grad.values())
                         for p in bucket_params[bucket.id]]
            flats = [bucket.flatten([g[d] for g in dev_grads],
                                    dev_grads[0][d].context)
                     for d in range(len(dev_grads[0]))]
            task = _ReduceTask(
                bucket.store_key, flats,
                lambda b=bucket, f=flats: self._register_bucket_key(b, f),
                kv=self._kvstore)
            in_flight.append((bucket, task, dev_grads))
            if serial:
                w0 = time.perf_counter()
                task.run(self._kvstore)
                stats["wait"] += time.perf_counter() - w0
            else:
                self._comm_q.put(task)
            return True

        def drain_one():
            bucket, task, dev_grads = in_flight.pop(0)
            w0 = time.perf_counter()
            task.wait()
            waited = time.perf_counter() - w0
            stats["wait"] += waited
            stats["comm"] += task.comm_seconds
            for d, flat in enumerate(task.flats):
                for grads, piece in zip(dev_grads, bucket.unflatten(flat)):
                    grads[d]._set_data(piece)
            _trace.complete("trainer::bucket_overlap", w0,
                            time.perf_counter(), bucket=bucket.id,
                            wait_s=round(waited, 6),
                            comm_s=round(task.comm_seconds, 6),
                            serial=serial)
            return bucket, task, dev_grads

        window = 1 if serial else max(1, depth)
        for _ in range(window):
            if not submit_one():
                break
        applier = self._applier
        applier.open_guard_window()
        processed = []                   # [(i, datas, grad)] per bucket
        pending_applies = []             # deferred under a global clip
        sumsq = []
        try:
            with _trace.span("trainer::update", fused=True,
                             overlapped=not serial,
                             buckets=len(buckets), unbucketed=len(odd)), \
                    _guard.updating():
                while in_flight:
                    bucket, task, dev_grads = drain_one()
                    submit_one()
                    work = [(i, list(p._data.values()), grads[0])
                            for i, p, grads in zip(
                                bucket.keys, bucket_params[bucket.id],
                                dev_grads)]
                    processed.append(work)
                    if clip is not None:
                        sumsq.append(bucket.sumsq(task.flats[0]))
                        pending_applies.append(work)
                        continue
                    self._apply_entries(work, None, manage_guard=False)
                odd_work, fallback = self._split_row_sparse(
                    self._reduce_odd(odd))
                scale = None
                if clip is not None:
                    sumsq += [_gn_sumsq(g._data) for _, _, g in odd_work]
                    total = math.fsum(float(v) for v in sumsq)
                    scale = min(1.0, clip / (math.sqrt(total) + 1e-8))
                    for work in pending_applies:
                        self._apply_entries(work, scale,
                                            manage_guard=False)
                self._apply_entries(odd_work, scale, manage_guard=False)
                self._apply_row_sparse(fallback)
                processed += [odd_work, fallback]
                # Copy the updated first replica to the other contexts.
                for work in processed:
                    for _, d, _ in work:
                        for dd in d[1:]:
                            dd[:] = d[0].as_in_context(dd.context)
        except BaseException:
            # Quiesce before raising: buckets on the comm thread keep
            # running there; wait them out (bounded) so nothing touches
            # the store or the gradients after step() raised.
            for _, task, _ in in_flight:
                if task.event.wait(timeout=60.0) and task.error is None \
                        and task.handle is not None:
                    try:
                        task.handle.wait(timeout=60.0)
                    except Exception:   # noqa: BLE001 — quiescing
                        pass
            raise
        finally:
            applier.close_guard_window()
        total_comm = stats["comm"]
        hidden = max(0.0, total_comm - stats["wait"])
        _reduce_seconds.inc(total_comm)
        _reduce_hidden_seconds.inc(hidden)
        _overlap_efficiency.set(hidden / total_comm if total_comm > 0
                                else 0.0)
        _update_seconds.observe(time.perf_counter() - t0)

    def _row_sparse_grad(self, grad):
        """A dense gradient as a RowSparseNDArray of its nonzero rows:
        found on its device on the fused path (only the row count
        reaches the host), through the host on the unfused one."""
        if self._fused:
            return _sp.dense_to_rsp_device(grad)
        host = grad.asnumpy()
        return _sp.row_sparse_array(host, ctx=grad.context, dtype=host.dtype)

    def _split_row_sparse(self, work):
        """`work` ([(index, datas, grad)]) split into the dense entries
        and those of row-sparse parameters, their gradients made
        row-sparse."""
        dense, sparse = [], []
        for i, d, g in work:
            if self._params[i]._grad_stype == "row_sparse":
                sparse.append((i, d, self._row_sparse_grad(g)))
            else:
                dense.append((i, d, g))
        return dense, sparse

    def _apply_row_sparse(self, entries):
        """The optimizer's row-sparse update, one parameter at a time."""
        for i, d, g in entries:
            self._updater(i, g, d[0])

    def _reduce_odd(self, odd):
        """Per-key reduce of the parameters the bucketer left out."""
        out = []
        for i in odd:
            p = self._params[i]
            grads = p.list_grad()
            self._kvstore.push(i, grads)
            self._kvstore.pull(i, grads)
            out.append((i, list(p._data.values()), grads[0]))
        return out

    def _apply_entries(self, work, scale, manage_guard=True):
        """Fused-apply `work` ([(index, datas, grad)]) on the first
        replica, the rest through the per-parameter updater.
        ``manage_guard=False`` inside an open guard window."""
        entries = [(i, d[0], g) for i, d, g in work]
        pending = self._applier.apply(entries, grad_scale=scale,
                                      manage_guard=manage_guard) \
            if self._fused and entries else entries
        for i, w, g in pending:
            if scale is not None and scale != 1.0:
                # Rounded to the gradient dtype, as the fused apply
                # rounds its runtime scale.
                g = g * _oo._c(scale, g._data.dtype)
            self._updater(i, g, w)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        assert not self._update_on_kvstore, \
            "update() is not supported with update_on_kvstore"
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Apply the optimizer once per parameter on the first replica,
        then copy the result to the other contexts (running one updater
        per context would advance Adam's t and the schedule once per
        context). Without a store the replicas' gradients are summed
        here, on the first context. Fused path (default): dense
        parameters of a supported family go through one pass per chunk
        of a (context, dtype) group, bit for bit the loop's update."""
        t0 = time.perf_counter()
        work = []
        for i, p in enumerate(self._params):
            if p._grad_req == "null" or p._data is None:
                continue
            datas = list(p._data.values())
            grads = list(p._grad.values())
            grad = grads[0]
            if len(grads) > 1 and self._kvstore is None:
                for g in grads[1:]:
                    grad = grad + g.as_in_context(grad.context)
                buf = self._merge_bufs.get(i)
                if buf is None:
                    buf = self._merge_bufs[i] = grad
                else:
                    buf._set_data(grad._data)
                grad = buf
            work.append((i, datas, grad))
        work, fallback = self._split_row_sparse(work)
        if self._global_norm_clip is not None and fallback:
            raise ValueError("global_norm_clip requires dense gradients")
        scale = None
        if self._global_norm_clip is not None and work:
            # fp32 per-param sums of squares, one host read, then the
            # reference clip_global_norm arithmetic in Python floats.
            with torch.no_grad():
                sums = [_gn_sumsq(g._data) for _, _, g in work]
                devs = {}
                for s in sums:
                    devs.setdefault(s.device, []).append(s)
                host = [v for d in devs.values()
                        for v in torch.stack(d).cpu().tolist()]
            total = math.fsum(host)
            # Exactly 1.0 below the limit: an exact multiply.
            scale = min(1.0,
                        self._global_norm_clip / (math.sqrt(total) + 1e-8))
        # The update writes weights and states in place, one chunk or
        # parameter at a time: no snapshot may see it half done.
        with _trace.span("trainer::update", fused=self._fused,
                         params=len(work) + len(fallback)), \
                _guard.updating():
            self._apply_entries(work, scale)
            self._apply_row_sparse(fallback)
            for _, d, _ in work + fallback:
                for dd in d[1:]:
                    dd[:] = d[0].as_in_context(dd.context)
        _update_seconds.observe(time.perf_counter() - t0)

    def save_states(self, fname):
        """Reference: trainer.py:save_states — the updater's state pickle,
        written atomically (tmp + rename)."""
        from ..base import atomic_write

        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Reference: trainer.py:load_states. Reads a payload of either
        package (``Updater.set_states``; the JAX package is never
        imported). Each state lands on its parameter's context, in the
        dtype the optimizer gives it there."""
        with open(fname, "rb") as f:
            self._set_states(f.read())

    def _set_states(self, payload):
        """Install an updater-state pickle of either package (also what
        ``checkpoint.load_trainer_state`` restores). The FusedApplier
        sees the replaced state entries and re-flattens its chunks from
        them at the next step."""
        states = self._updater.states
        for i, p in enumerate(self._params):
            if p._grad_req != "null" and p._data is not None and \
                    i not in states:
                states[i] = self._optimizer.create_state_multi_precision(
                    i, p.list_data()[0])
        self._updater.set_states(payload)
        self._updater.optimizer = self._optimizer
