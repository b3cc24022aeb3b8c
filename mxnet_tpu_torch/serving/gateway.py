"""mxnet_tpu_torch.serving.gateway — multi-model inference gateway.

Counterpart of ``mxnet_tpu/serving/gateway.py`` (a copy: it calls only
the backends, the telemetry and ``nd``; its request batches are
NDArrays on the gateway's context). One process, N named models, ONE bounded admission pool and ONE worker
thread owning all device calls. The single-model ``InferenceServer``
scales out by replication; this gateway is the tier that fronts many
models at once:

* **Fair-share scheduling.** Each model owns a micro-batcher queue
  (the two-trigger policy: dispatch on a full bucket or when the
  oldest request has waited ``max_delay_ms``). Among models with a
  dispatchable batch, the worker picks by *smooth weighted
  round-robin* over the specs' ``weight`` — a hot model gets its
  proportional share and can never starve the rest (its excess load
  queues against the shared pool bound and sheds at ITS door).

* **Deadline classes.** A request names a class from its model's
  ordered ladder (``ModelSpec.deadline_classes``) and inherits the
  class deadline. Expired queued requests shed exactly like the
  single-model server.

* **SLO-coupled shedding.** A model with a declared ``slo=`` gets a
  :class:`~..telemetry.slo.ServiceLevelObjective` over its own
  ``mx_serving_gateway_request_latency_seconds{model=...}`` series,
  evaluated by one :class:`~..telemetry.slo.BurnRateMonitor`. While
  every window burns past ``shed_burn_rate``, admission sheds that
  model's LOWEST deadline class (503) — load shedding by priority
  instead of collapsing p99 for every caller of every model.

* **Per-model readiness.** Every model claims its own health-plane
  component slot (``gateway/<name>``): a model still warming (or
  registered with ``warmup=False``) sheds 503 for ITSELF only while
  the other models keep serving; ``unregister`` releases the slot.

* **Hot reload.** :func:`.reload.hot_swap` builds + warms a NEW
  backend off-path, then :meth:`ModelGateway.swap_backend` swaps the
  backend atomically under the registry's generation counter.
  Every response is a :class:`GatewayResult` tagged with the
  generation that produced it, so no request can mix versions.

Telemetry: ``mx_serving_gateway_*{model=...}`` families,
``serving::gateway_*``/``serving::swap`` spans, one ``serving`` lane on
the hang watchdog, one readiness slot per model.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from .. import log as _log
from .. import ndarray as nd
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..telemetry import healthplane as _hp
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import watchdog as _watchdog
from ..telemetry import xtrace as _xtrace
from ..telemetry.slo import BurnRateMonitor, ServiceLevelObjective
from .admission import QueueFullError, ServiceUnavailableError, \
    DeadlineExceededError
from .continuous import DecodeLoop
from .continuous import drop_metrics as _drop_decode_metrics
from .registry import ModelRegistry, ModelSpec

__all__ = ["ModelGateway", "GatewayResult"]

_gw_requests = _tm.REGISTRY.counter(
    "mx_serving_gateway_requests_total",
    "Requests admitted to the gateway pool",
    labels=("model", "deadline_class"))
_gw_batches = _tm.REGISTRY.counter(
    "mx_serving_gateway_batches_total",
    "Gateway device batch calls", labels=("model", "bucket"))
_gw_rows = _tm.REGISTRY.counter(
    "mx_serving_gateway_rows_total",
    "Real (unpadded) rows executed per model and bucket",
    labels=("model", "bucket"))
_gw_latency = _tm.REGISTRY.histogram(
    "mx_serving_gateway_request_latency_seconds",
    "submit()-to-result latency per request (queueing included); the "
    "family each model's SLO burn rate evaluates", labels=("model",))
_gw_shed = _tm.REGISTRY.counter(
    "mx_serving_gateway_shed_total",
    "Requests shed at the gateway: reason=queue_full|deadline|unready|"
    "slo_burn|unregister", labels=("model", "reason", "deadline_class"))
_gw_queue = _tm.REGISTRY.gauge(
    "mx_serving_gateway_queue_depth",
    "Queued requests per model", labels=("model",))
_gw_generation = _tm.REGISTRY.gauge(
    "mx_serving_gateway_generation",
    "Committed model version (bumped by every hot reload)",
    labels=("model",))
_gw_shedding = _tm.REGISTRY.gauge(
    "mx_serving_gateway_slo_shedding",
    "1 while a model's SLO burn rate sheds its lowest deadline class",
    labels=("model",))
# Label-less on purpose: unregister drops the model's labeled series,
# and the drain outcome must survive that (goodput's serving analog
# reads these after the model is gone).
_gw_unreg_drained = _tm.REGISTRY.counter(
    "mx_gateway_unregister_drained_total",
    "Queued/in-flight requests served during drain-aware unregister "
    "before the backend was dropped")
_gw_unreg_shed = _tm.REGISTRY.counter(
    "mx_gateway_unregister_shed_total",
    "Requests failed by unregister after the drain timeout (or with "
    "drain=False) — gateway badput in the goodput ledger")

_logger = _log.get_logger("mxnet_tpu_torch.serving")


class GatewayResult:
    """One request's outcome: the output rows plus the model version
    that produced them — every response carries exactly ONE generation,
    which is how the no-mixed-weights reload contract is asserted."""

    __slots__ = ("output", "model", "generation")

    def __init__(self, output, model, generation):
        self.output = output
        self.model = model
        self.generation = generation

    def __repr__(self):
        return "GatewayResult(model=%r, generation=%d, output=%r)" % (
            self.model, self.generation, self.output)


class _GwRequest:
    __slots__ = ("data", "rows", "future", "deadline", "t_submit", "cls",
                 "ctx")

    def __init__(self, data, rows, deadline, t_submit, cls):
        self.data = data
        self.rows = rows
        self.future = Future()
        self.deadline = deadline
        self.t_submit = t_submit
        self.cls = cls
        # The request's trace context: adopted from the submitter when
        # one is active, else a fresh root — every span of this
        # request's admission -> queue -> batch -> respond life (and
        # any kvstore traffic the backend performs) carries it.
        ctx = _xtrace.current()
        self.ctx = ctx if ctx is not None else _xtrace.new_root()


class _ModelState:
    __slots__ = ("spec", "backend", "generation", "component", "queue",
                 "rows_queued", "current", "ready", "shedding", "slo",
                 "warmed", "inflight", "loop", "seqs_queued", "draining")

    def __init__(self, spec, backend, generation, component):
        self.spec = spec
        self.backend = backend
        self.generation = generation
        self.component = component
        self.queue = deque()
        self.rows_queued = 0
        self.current = 0.0        # smooth-WRR accumulator
        self.ready = False
        self.shedding = False
        self.slo = None
        self.warmed = set()
        self.inflight = {}        # generation -> in-flight batch count
        self.loop = None          # DecodeLoop for decode specs
        self.seqs_queued = 0      # decode requests counted in the pool
        self.draining = False     # unregister drain: no new admissions


class ModelGateway:
    """N models behind one bounded admission pool.

    Parameters
    ----------
    registry : ModelRegistry, optional (one is created when omitted).
    max_queue : int
        TOTAL queued requests across all models
        (default ``MXNET_GATEWAY_MAX_QUEUE``); past it ``submit()``
        raises :class:`QueueFullError`.
    max_delay_ms : float
        Per-model batching window (two-trigger micro-batching).
    shed_burn_rate : float
        Burn rate at which a model's SLO starts shedding its lowest
        deadline class (default ``MXNET_GATEWAY_SHED_BURN_RATE``).
    burn_windows : SLO evaluation windows in seconds (short, serving-
        scale defaults — shedding must react in seconds, not the
        alerting-scale 5m/1h).
    eval_interval_s : at most one burn evaluation per this many seconds.
    clock : injectable monotonic clock for the burn-rate machinery.
    monitor : optional telemetry.StepMonitor for burn-alert routing.
    ctx : device context for request batches, and of every model whose
        spec names none (default: the current context at construction).
    start : start the worker thread at construction (default True).
    """

    def __init__(self, registry=None, *, max_queue=None, max_delay_ms=5.0,
                 shed_burn_rate=None, burn_windows=(60.0, 300.0),
                 eval_interval_s=5.0, clock=time.monotonic, monitor=None,
                 ctx=None, start=True):
        from .. import env as _env

        self.registry = registry if registry is not None else ModelRegistry()
        self._max_queue = int(max_queue if max_queue is not None
                              else _env.get("MXNET_GATEWAY_MAX_QUEUE"))
        if self._max_queue < 1:
            raise ValueError("max_queue must be >= 1, got %r"
                             % (self._max_queue,))
        self._max_delay = float(max_delay_ms) / 1e3
        self._shed_burn = float(
            shed_burn_rate if shed_burn_rate is not None
            else _env.get("MXNET_GATEWAY_SHED_BURN_RATE"))
        self._burn = BurnRateMonitor(
            windows=burn_windows, alert_burn_rate=self._shed_burn,
            eval_interval_s=eval_interval_s, monitor=monitor, clock=clock)
        self._burn_lock = threading.Lock()
        self._monitor = monitor
        self._ctx = ctx if ctx is not None else current_context()
        self._models = {}
        self._cond = threading.Condition()
        self._total = 0
        self._running = False
        self._paused = False
        self._closed = False
        self._thread = None
        self._wd_lane = _watchdog.unique_lane("serving")
        if start:
            self.start()

    # -- model lifecycle -------------------------------------------------------

    def register(self, spec=None, warmup=True, **kwargs):
        """Register a model (a :class:`ModelSpec`, or its kwargs) and
        build its version-1 backend. With ``warmup=True`` the full
        bucket ladder runs once before returning and the model turns
        ready; with
        ``warmup=False`` the model sheds 503 until
        :meth:`warmup` is called — other models are unaffected
        (readiness is per model). Returns the spec."""
        if spec is None:
            spec = ModelSpec(**kwargs)
        elif kwargs:
            raise ValueError("pass a ModelSpec OR its kwargs, not both")
        if spec.ctx is None:
            # Backends place their params where the requests run: the
            # worker thread has no context of its own to default to.
            spec.ctx = self._ctx
        with self._cond:
            if self._closed:
                raise RuntimeError("gateway is shut down")
        self.registry.register(spec)
        try:
            backend = spec.build_backend()
        except Exception:
            self.registry.unregister(spec.name)
            raise
        component = _hp.unique_component("gateway/%s" % spec.name)
        st = _ModelState(spec, backend, self.registry.generation(spec.name),
                         component)
        if spec.decode is not None:
            # Sequence requests bypass the batcher queue entirely: the
            # model's DecodeLoop owns its device and schedules at step
            # granularity; the hooks keep them inside the gateway's ONE
            # admission pool (release) and shed accounting (shed).
            st.loop = DecodeLoop(
                spec, backend, st.generation,
                release=lambda n, depth, _st=st:
                    self._seq_release(_st, n, depth),
                shed=lambda seq, reason, _name=spec.name:
                    _gw_shed.labels(model=_name, reason=reason,
                                    deadline_class=seq.cls).inc())
        if spec.slo is not None:
            objective, threshold_s = spec.slo
            st.slo = ServiceLevelObjective(
                "gateway_%s" % spec.name, objective, threshold_s,
                _gw_latency, labels={"model": spec.name})
            with self._burn_lock:
                self._burn.add(st.slo)
        with self._cond:
            if self._closed:
                # shutdown raced the build: unwind every side effect so
                # no ghost registry entry / not-ready component / SLO
                # survives the refused registration.
                closed = True
            else:
                closed = False
                self._models[spec.name] = st
        if closed:
            self.registry.unregister(spec.name)
            _hp.clear_ready(component)
            if st.loop is not None:
                st.loop.close(drain=False)
            if st.slo is not None:
                with self._burn_lock:
                    self._burn.remove(st.slo.name)
            raise RuntimeError("gateway is shut down")
        _gw_generation.labels(model=spec.name).set(st.generation)
        _gw_queue.labels(model=spec.name).set(0)
        if warmup:
            self.warmup(spec.name)
        return spec

    def warm_backend(self, spec, backend, skip=()):
        """Run a backend's bucket ladder (minus ``skip``) with the same
        device placement the serving path uses — THE warmup for
        registration and for reload's off-path new-version warmup.
        Returns the set of warmed buckets. Decode backends warm their
        own ladder (one step signature per page count, one prefill per
        prompt-length bucket) instead of the item-shape batches."""
        if spec.decode is not None:
            return backend.warm()
        warmed = set()
        for b in spec.policy.buckets:
            if b in skip:
                continue
            batch = nd.array(np.zeros((b,) + spec.item_shape, spec.dtype),
                             ctx=spec.ctx if spec.ctx is not None
                             else self._ctx)
            out = backend(batch)
            for o in (out if isinstance(out, tuple) else (out,)):
                o.wait_to_read()
            warmed.add(b)
        return warmed

    def warmup(self, name):
        """Warm the model's full bucket ladder (idempotent) and flip its
        readiness slot. Safe while the gateway serves other models:
        the backend is private to this model and unreachable by the
        worker until readiness flips."""
        st = self._state(name)
        st.warmed |= self.warm_backend(st.spec, st.backend,
                                       skip=st.warmed)
        if not st.ready:
            st.ready = True
            _hp.set_ready(st.component)
        with self._cond:
            self._cond.notify_all()
        return self

    def unregister(self, name, drain=True, drain_timeout=None):
        """Drop a model — after serving what it already accepted. With
        ``drain`` (default) new admissions stop immediately, but the
        worker keeps dispatching the model's queued requests until the
        queue and its in-flight batches empty, bounded by
        ``drain_timeout`` (default ``MXNET_GATEWAY_DRAIN_TIMEOUT_S``);
        served work counts on ``mx_gateway_unregister_drained_total``.
        Whatever the timeout strands fails with
        :class:`ServiceUnavailableError` and is shed with
        ``reason="unregister"`` — gateway badput in the goodput ledger.
        Either way the readiness slot is RELEASED (no permanently
        not-ready ghost in ``/readyz``), the SLO leaves the burn
        monitor, and the model's labeled series leave the registry
        families."""
        from .. import env as _env

        if drain_timeout is None:
            drain_timeout = _env.get("MXNET_GATEWAY_DRAIN_TIMEOUT_S")
        drained = 0
        with self._cond:
            st = self._models.get(name)
            if st is None:
                raise KeyError("model %r is not registered" % (name,))
            st.draining = True
            target = len(st.queue)
            # Only a live, unpaused worker can serve the queue; without
            # one the wait below could never make progress.
            can_drain = (drain and self._running and not self._closed
                         and not self._paused
                         and self._thread is not None and st.ready)
            if can_drain:
                deadline = time.monotonic() + float(drain_timeout)
                while st.queue or st.inflight:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(0.1, remaining))
            # Requests no longer queued were picked for dispatch —
            # their futures resolve through the batch path even if a
            # straggler batch is still in flight at the timeout.
            drained = target - len(st.queue)
            self._models.pop(name, None)
            self._total -= len(st.queue)
            failed = list(st.queue)
            st.queue.clear()
            st.rows_queued = 0
        self.registry.unregister(name)
        seq_drained = 0
        if st.loop is not None:
            if drain:
                # In-flight sequences finish on the loop's own drain;
                # pending ones fail through its shed path, and the
                # release hook settles the pool accounting.
                seq_drained = st.loop.occupancy
            st.loop.close(drain=drain, timeout=float(drain_timeout))
        for req in failed:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    ServiceUnavailableError("model %r unregistered" % name))
            _gw_shed.labels(model=name, reason="unregister",
                            deadline_class=req.cls).inc()
        if drained + seq_drained:
            _gw_unreg_drained.inc(drained + seq_drained)
        if failed:
            _gw_unreg_shed.inc(len(failed))
        _hp.clear_ready(st.component)
        if st.slo is not None:
            with self._burn_lock:
                self._burn.remove(st.slo.name)
        self._drop_metrics(name)
        _drop_decode_metrics(name)
        return st.spec

    @staticmethod
    def _drop_metrics(name):
        for fam in (_gw_requests, _gw_batches, _gw_rows, _gw_latency,
                    _gw_shed, _gw_queue, _gw_generation, _gw_shedding):
            for values, _ in fam.collect():
                if values[0] == name:
                    fam.remove(**dict(zip(fam.labelnames, values)))

    def _state(self, name):
        with self._cond:
            st = self._models.get(name)
        if st is None:
            raise KeyError("model %r is not registered (have: %s)"
                           % (name, self.models() or "none"))
        return st

    def models(self):
        with self._cond:
            return sorted(self._models)

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        with self._cond:
            if self._closed:
                raise RuntimeError("gateway is shut down")
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="mx-serving-gateway", daemon=True)
            self._thread.start()
        return self

    def pause(self):
        """Stop dispatching (submits still queue) — drain control and
        deterministic-coalescing tests."""
        with self._cond:
            self._paused = True
        return self

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the worker (drain semantics of the single-model
        server), release the watchdog lane and every model's readiness
        slot."""
        with self._cond:
            self._closed = True
            self._running = False
            self._paused = False
            if not drain or self._thread is None:
                for st in self._models.values():
                    while st.queue:
                        req = st.queue.popleft()
                        if req.future.set_running_or_notify_cancel():
                            req.future.set_exception(
                                RuntimeError("gateway shut down"))
                    st.rows_queued = 0
                self._total = 0
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout if timeout is not None else 30)
        _watchdog.reset(self._wd_lane)
        with self._cond:
            states = list(self._models.values())
        for st in states:
            if st.loop is not None:
                st.loop.close(drain=drain, timeout=timeout)
            _hp.clear_ready(st.component)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- request path ----------------------------------------------------------

    def submit(self, model, data, deadline_class=None, timeout_ms=None):
        """Enqueue one request for ``model``; returns a Future yielding
        a :class:`GatewayResult`. ``deadline_class`` defaults to the
        model's FIRST (highest-priority) class; ``timeout_ms``
        overrides the class deadline."""
        self._burn_tick()
        st = self._state(model)
        spec = st.spec
        if spec.decode is not None:
            raise ValueError("model %r is a decode model: use "
                             "submit_sequence()" % (model,))
        arr = data.asnumpy() if isinstance(data, NDArray) \
            else np.array(data, dtype=spec.dtype)
        if tuple(arr.shape[1:]) != spec.item_shape:
            raise ValueError(
                "request shape %r does not match (k,) + item_shape %r "
                "of model %r" % (tuple(arr.shape), spec.item_shape, model))
        rows = int(arr.shape[0])
        if not 1 <= rows <= spec.policy.max_batch:
            raise ValueError("request rows must be in [1, %d], got %d"
                             % (spec.policy.max_batch, rows))
        cls = deadline_class if deadline_class is not None \
            else spec.default_class
        if cls not in spec.class_timeouts:
            raise ValueError("unknown deadline class %r for model %r "
                             "(have: %s)" % (cls, model,
                                             [c for c, _ in spec.classes]))
        now = time.perf_counter()
        if timeout_ms is None:
            timeout_ms = spec.class_timeouts[cls]
        deadline = now + timeout_ms / 1e3 if timeout_ms is not None else None
        req = _GwRequest(arr.astype(spec.dtype, copy=False), rows,
                         deadline, now, cls)
        with self._cond:
            if self._closed:
                raise RuntimeError("gateway is shut down")
            st2 = self._models.get(model)
            if st2 is not st:
                raise KeyError("model %r is not registered" % (model,))
            if st.draining:
                _gw_shed.labels(model=model, reason="unregister",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is draining for unregister — no new "
                    "admissions" % model)
            if not st.ready:
                _gw_shed.labels(model=model, reason="unready",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is not ready (warmup in flight) — other "
                    "models keep serving; retry another replica" % model)
            if st.shedding and cls == spec.lowest_class:
                _gw_shed.labels(model=model, reason="slo_burn",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is burning its SLO error budget: shedding "
                    "deadline class %r" % (model, cls))
            if self._total >= self._max_queue:
                _gw_shed.labels(model=model, reason="queue_full",
                                deadline_class=cls).inc()
                raise QueueFullError(
                    "gateway pool full (%d pending, max_queue=%d)"
                    % (self._total, self._max_queue))
            share_cap = self._share_cap(spec)
            if share_cap is not None and len(st.queue) >= share_cap:
                _gw_shed.labels(model=model, reason="queue_full",
                                deadline_class=cls).inc()
                raise QueueFullError(
                    "model %r queue share exhausted (%d queued, "
                    "queue_share=%.2f of %d)"
                    % (model, len(st.queue), spec.queue_share,
                       self._max_queue))
            st.queue.append(req)
            st.rows_queued += rows
            self._total += 1
            depth = len(st.queue)
            self._cond.notify_all()
        _gw_requests.labels(model=model, deadline_class=cls).inc()
        _gw_queue.labels(model=model).set(depth)
        with _xtrace.activate(req.ctx):
            _trace.instant("serving::gateway_enqueue", model=model,
                           rows=rows, depth=depth)
        return req.future

    def predict(self, model, data, deadline_class=None, timeout_ms=None):
        """Synchronous submit; returns the :class:`GatewayResult`."""
        return self.submit(model, data, deadline_class=deadline_class,
                           timeout_ms=timeout_ms).result()

    def _share_cap(self, spec):
        """Per-model queue bound from ``ModelSpec.queue_share`` (None =
        only the shared pool bound applies)."""
        if spec.queue_share is None:
            return None
        return max(1, -int(-spec.queue_share * self._max_queue // 1))

    # -- sequence request path (continuous batching) ---------------------------

    def submit_sequence(self, model, prompt, deadline_class=None,
                        timeout_ms=None, max_tokens=None):
        """Enqueue one SEQUENCE for a decode model (continuous
        batching); returns a Future yielding a
        :class:`~.continuous.SequenceResult`. Admission runs through
        the same pool, readiness, SLO-shedding, and deadline-class
        ladder as :meth:`submit` — the deadline covers the WHOLE
        sequence, so a slow decode sheds mid-flight."""
        self._burn_tick()
        st = self._state(model)
        spec = st.spec
        if spec.decode is None:
            raise ValueError("model %r is not a decode model: use "
                             "submit()" % (model,))
        cls = deadline_class if deadline_class is not None \
            else spec.default_class
        if cls not in spec.class_timeouts:
            raise ValueError("unknown deadline class %r for model %r "
                             "(have: %s)" % (cls, model,
                                             [c for c, _ in spec.classes]))
        now = time.perf_counter()
        if timeout_ms is None:
            timeout_ms = spec.class_timeouts[cls]
        deadline = now + timeout_ms / 1e3 if timeout_ms is not None \
            else None
        with self._cond:
            if self._closed:
                raise RuntimeError("gateway is shut down")
            st2 = self._models.get(model)
            if st2 is not st:
                raise KeyError("model %r is not registered" % (model,))
            if st.draining:
                _gw_shed.labels(model=model, reason="unregister",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is draining for unregister — no new "
                    "admissions" % model)
            if not st.ready:
                _gw_shed.labels(model=model, reason="unready",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is not ready (warmup in flight)" % model)
            if st.shedding and cls == spec.lowest_class:
                _gw_shed.labels(model=model, reason="slo_burn",
                                deadline_class=cls).inc()
                raise ServiceUnavailableError(
                    "model %r is burning its SLO error budget: shedding "
                    "deadline class %r" % (model, cls))
            if self._total >= self._max_queue:
                _gw_shed.labels(model=model, reason="queue_full",
                                deadline_class=cls).inc()
                raise QueueFullError(
                    "gateway pool full (%d pending, max_queue=%d)"
                    % (self._total, self._max_queue))
            share_cap = self._share_cap(spec)
            if share_cap is not None and st.seqs_queued >= share_cap:
                _gw_shed.labels(model=model, reason="queue_full",
                                deadline_class=cls).inc()
                raise QueueFullError(
                    "model %r queue share exhausted (%d queued, "
                    "queue_share=%.2f of %d)"
                    % (model, st.seqs_queued, spec.queue_share,
                       self._max_queue))
            self._total += 1
            st.seqs_queued += 1
        # The loop's own lock is taken OUTSIDE the gateway lock (the
        # release hook goes loop-thread -> gateway lock; nesting the
        # other way here would be an inversion).
        try:
            seq = st.loop.submit(prompt, max_tokens=max_tokens,
                                 deadline=deadline, cls=cls)
        except Exception:
            with self._cond:
                self._total -= 1
                st.seqs_queued -= 1
            raise
        _gw_requests.labels(model=model, deadline_class=cls).inc()
        _gw_queue.labels(model=model).set(st.loop.pending)
        return seq.future

    def generate(self, model, prompt, deadline_class=None,
                 timeout_ms=None, max_tokens=None):
        """Synchronous :meth:`submit_sequence`; returns the
        :class:`~.continuous.SequenceResult`."""
        return self.submit_sequence(
            model, prompt, deadline_class=deadline_class,
            timeout_ms=timeout_ms, max_tokens=max_tokens).result()

    def _seq_release(self, st, n, depth):
        """DecodeLoop release hook: ``n`` sequences left the model's
        pending queue (admitted into slots, shed, or failed) — return
        their pool capacity. Called by the loop WITHOUT its lock held."""
        with self._cond:
            self._total -= n
            st.seqs_queued -= n
            self._cond.notify_all()
        _gw_queue.labels(model=st.spec.name).set(depth)

    # -- hot reload seam (driven by serving.reload) ----------------------------

    def swap_backend(self, name, backend, warmed=None, drain_timeout=None):
        """Atomically commit a new backend under the registry's
        generation counter, then wait for in-flight batches of the OLD
        generation to drain. Admission never closes and queues are
        untouched — zero dropped requests by construction. Returns
        ``(new_generation, drained)``; after a drained return the old
        backend (and its whole signature cache) is unreferenced."""
        from .. import env as _env

        if drain_timeout is None:
            drain_timeout = _env.get("MXNET_GATEWAY_DRAIN_TIMEOUT_S")
        with self._cond:
            st = self._models.get(name)
            if st is None:
                raise KeyError("model %r is not registered" % (name,))
        if st.loop is not None:
            # Decode models: the loop owns the drain (in-flight
            # SEQUENCES finish on their admit-time generation before
            # the new backend takes the slots) — zero drops, same
            # contract at sequence granularity.
            new_gen = self.registry.bump(name)
            drained = st.loop.swap_backend(backend, new_gen,
                                           drain_timeout=drain_timeout)
            with self._cond:
                st.backend = backend
                st.generation = new_gen
            _trace.instant("serving::swap_commit", model=name,
                           generation=new_gen)
            _gw_generation.labels(model=name).set(new_gen)
            return new_gen, drained
        with self._cond:
            st2 = self._models.get(name)
            if st2 is not st:
                raise KeyError("model %r is not registered" % (name,))
            old_gen = st.generation
            st.backend = backend
            st.warmed = set(warmed if warmed is not None
                            else st.spec.policy.buckets)
            st.generation = self.registry.bump(name)
            new_gen = st.generation
            _trace.instant("serving::swap_commit", model=name,
                           generation=new_gen)
            deadline = time.monotonic() + float(drain_timeout)
            while st.inflight.get(old_gen, 0) > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(0.1, remaining))
            drained = st.inflight.get(old_gen, 0) == 0
        _gw_generation.labels(model=name).set(new_gen)
        return new_gen, drained

    # -- stats -----------------------------------------------------------------

    def stats(self):
        """Per-model registry view: bucket occupancy, shed counts,
        generation/readiness/shedding state, queue depth, p50/p99."""
        out = {}
        with self._cond:
            states = dict(self._models)
        for name, st in sorted(states.items()):
            batches, rows, requests, shed = {}, {}, {}, {}
            for values, child in _gw_batches.collect():
                if values[0] == name:
                    batches[values[1]] = child.value
            for values, child in _gw_rows.collect():
                if values[0] == name:
                    rows[values[1]] = child.value
            for values, child in _gw_requests.collect():
                if values[0] == name and child.value:
                    requests[values[1]] = child.value
            for values, child in _gw_shed.collect():
                if values[0] == name and child.value:
                    shed["%s:%s" % (values[1], values[2])] = child.value
            lat = None
            for values, child in _gw_latency.collect():
                if values[0] == name:
                    lat = child
            buckets = {}
            for b in sorted(batches, key=int):
                n_batches = batches[b]
                buckets[int(b)] = {
                    "batches": n_batches,
                    "rows": rows.get(b, 0),
                    "mean_occupancy": (rows.get(b, 0)
                                       / (n_batches * int(b))
                                       if n_batches else 0.0),
                }
            out[name] = {
                "generation": st.generation,
                "ready": st.ready,
                "shedding": st.shedding,
                "queue_depth": len(st.queue),
                "requests": requests,
                "buckets": buckets,
                "shed": shed,
                "p50_ms": (lat.quantile(0.50) if lat else 0.0) * 1e3,
                "p99_ms": (lat.quantile(0.99) if lat else 0.0) * 1e3,
            }
            if st.loop is not None:
                out[name]["decode"] = st.loop.stats()
        return out

    # -- SLO-coupled shedding --------------------------------------------------

    def _burn_tick(self):
        """Evaluate SLO burn rates (rate-limited by eval_interval_s)
        and flip per-model shedding state. Called from submit() and the
        worker loop; serialized by its own lock, which is never held
        while taking the queue lock's critical work."""
        with self._burn_lock:
            res = self._burn.tick()
        if res is None:
            return
        with self._cond:
            states = dict(self._models)
        for name, st in states.items():
            if st.slo is None:
                continue
            burns = res.get(st.slo.name)
            if burns is None:
                continue
            shed = bool(burns) and min(burns.values()) >= self._shed_burn
            if shed != st.shedding:
                st.shedding = shed
                _gw_shedding.labels(model=name).set(int(shed))
                _trace.instant("serving::gateway_slo_shed", model=name,
                               active=int(shed))

    # -- worker ----------------------------------------------------------------

    def _loop(self):
        while True:
            try:
                self._burn_tick()
            except Exception as exc:
                # The burn monitor may route alerts through injected
                # hooks (monitor=); a hook exception must never kill
                # the one thread that owns every model's dispatch.
                _log.warn_rate_limited(
                    _logger, "gw_burn_tick", 60.0,
                    "gateway burn-rate tick failed (SLO shedding state "
                    "may be stale): %s", exc)
            with self._cond:
                while self._running and (self._paused
                                         or self._total == 0):
                    self._cond.wait(0.1)
                if self._total == 0:
                    if not self._running:
                        return
                    continue
                self._shed_expired_locked()
                if self._total == 0:
                    continue
                picked = self._pick_locked()
                if picked is None:
                    continue
                st, batch = picked
                backend, gen = st.backend, st.generation
                st.inflight[gen] = st.inflight.get(gen, 0) + 1
            try:
                live = [r for r in batch
                        if r.future.set_running_or_notify_cancel()]
                if live:
                    bucket = st.spec.policy.bucket_for(
                        sum(r.rows for r in live))
                    try:
                        self._run_batch(st.spec, backend, gen, live,
                                        bucket)
                    except Exception as exc:
                        for req in live:
                            if not req.future.done():
                                req.future.set_exception(exc)
            finally:
                with self._cond:
                    n = st.inflight.get(gen, 0) - 1
                    if n > 0:
                        st.inflight[gen] = n
                    else:
                        st.inflight.pop(gen, None)
                    self._cond.notify_all()
                # Drop the backend reference before the next wait: a
                # swapped-out generation must be released by the worker
                # too, or its weights survive the drain.
                st = backend = batch = live = None

    _SHED_GRACE = 10e-3
    _DEADLINE_MARGIN = 2e-3

    def _shed_expired_locked(self):
        now = time.perf_counter()
        for name, st in self._models.items():
            if not st.queue:
                continue
            live = deque()
            while st.queue:
                req = st.queue.popleft()
                self._total -= 1
                st.rows_queued -= req.rows
                if req.future.cancelled():
                    continue
                if (req.deadline is not None
                        and now > req.deadline + self._SHED_GRACE):
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(DeadlineExceededError(
                            "request expired after %.1f ms in queue"
                            % ((now - req.t_submit) * 1e3)))
                    _gw_shed.labels(model=name, reason="deadline",
                                    deadline_class=req.cls).inc()
                    # Tail capture: the expired request's trace is now
                    # anomalous — the next flight-recorder bundle
                    # carries its full span tree (peer ranks included).
                    _xtrace.flag(req.ctx, "deadline_exceeded",
                                 note="model=%s class=%s" % (name,
                                                             req.cls))
                    if self._monitor is not None:
                        self._monitor.record_anomaly(
                            "deadline_exceeded",
                            "gateway %s: request expired in queue" % name)
                else:
                    live.append(req)
                    self._total += 1
                    st.rows_queued += req.rows
            st.queue = live

    def _due_at(self, st, now):
        """When this model's queue becomes dispatchable: immediately on
        a full bucket, else at the two-trigger delay (capped by the
        earliest queued deadline so an idle device never sheds what it
        had time to serve)."""
        if st.rows_queued >= st.spec.policy.max_batch:
            return now
        delay = self._max_delay if st.spec.max_delay_ms is None \
            else st.spec.max_delay_ms / 1e3
        due = st.queue[0].t_submit + delay
        rows = 0
        for req in st.queue:
            if rows + req.rows > st.spec.policy.max_batch:
                break
            rows += req.rows
            if req.deadline is not None:
                due = min(due, req.deadline - self._DEADLINE_MARGIN)
        return due

    def _pick_locked(self):
        """Smooth weighted round-robin over models with a dispatchable
        batch; collects the picked model's FIFO prefix. Returns None
        after waiting when nobody is due yet."""
        now = time.perf_counter()
        waiting = [st for st in self._models.values() if st.queue]
        due = [st for st in waiting if self._due_at(st, now) <= now]
        if not due:
            if waiting:
                wake = min(self._due_at(st, now) for st in waiting)
                wait = wake - now
                if wait > 0:
                    self._cond.wait(wait)
            else:
                # Only sequences the decode loops own are pending: sleep
                # until a submit (or a release) notifies, instead of
                # spinning on the pool count.
                self._cond.wait(0.1)
            return None
        total_w = sum(st.spec.weight for st in due)
        for st in due:
            st.current += st.spec.weight
        st = max(due, key=lambda s: s.current)
        st.current -= total_w
        take, rows = [], 0
        while st.queue:
            req = st.queue[0]
            if rows + req.rows > st.spec.policy.max_batch:
                break
            take.append(st.queue.popleft())
            rows += req.rows
        st.rows_queued -= rows
        self._total -= len(take)
        _gw_queue.labels(model=st.spec.name).set(len(st.queue))
        return st, take

    def _run_batch(self, spec, backend, generation, requests, bucket):
        """One device call for one model's coalesced batch — runs on
        the worker thread under the serving watchdog lane."""
        _watchdog.begin(self._wd_lane)
        try:
            t0 = time.perf_counter()
            name = spec.name
            batch = np.zeros((bucket,) + spec.item_shape, spec.dtype)
            spans, off = [], 0
            for req in requests:
                batch[off:off + req.rows] = req.data
                spans.append((req, off, off + req.rows))
                off += req.rows
            for req in requests:
                with _xtrace.activate(req.ctx):
                    _trace.complete("serving::gateway_queue_wait",
                                    req.t_submit, t0, model=name,
                                    rows=req.rows, bucket=bucket)
            # The device slice (and the backend call inside it) runs
            # under the FIRST request's context: one owner per batch
            # keeps the flow an arrow chain, and any kvstore traffic
            # the backend performs injects that request's trace.
            with _xtrace.activate(requests[0].ctx), \
                    _trace.span("serving::gateway_device", model=name,
                                bucket=bucket, rows=off,
                                generation=generation):
                out = backend(nd.array(batch,
                                       ctx=spec.ctx if spec.ctx is not None
                                       else self._ctx))
                outs = out if isinstance(out, tuple) else (out,)
                for o in outs:
                    o.wait_to_read()
            b = str(bucket)
            _gw_batches.labels(model=name, bucket=b).inc()
            _gw_rows.labels(model=name, bucket=b).inc(off)
            done = time.perf_counter()
            lat = _gw_latency.labels(model=name)
            for req, i0, i1 in spans:
                sliced = tuple(o[i0:i1] for o in outs)
                with _xtrace.activate(req.ctx):
                    lat.observe(done - req.t_submit)
                    _trace.complete("serving::gateway_request",
                                    req.t_submit, done, model=name,
                                    rows=req.rows, bucket=bucket)
                req.future.set_result(GatewayResult(
                    sliced if len(sliced) > 1 else sliced[0],
                    name, generation))
        finally:
            _watchdog.end(self._wd_lane)
