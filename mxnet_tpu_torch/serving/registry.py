"""Model registry for the multi-model inference gateway.

Counterpart of ``mxnet_tpu/serving/registry.py``. A :class:`ModelSpec`
is the serving-side description of ONE model: how to build its backend
(a pure ``fn(*params, data)`` or a ``model.save_checkpoint`` artifact),
its bucket ladder, its fair-share weight, its deadline classes, an
optional latency SLO, and an optional execution variant: ``quantize=``
(int8 weight-only or bf16 compute, riding :mod:`..ops.quantization_ops`)
or ``mesh_axes=`` (the params split over a mesh of ranks, for models too
large for one card).

Every backend runs its buckets through the port's signature-counting
``CachedOp`` (or, for a checkpoint, one Executor per bucket), where the
JAX package compiles one XLA executable per bucket; ``compile_count``
counts the same events.

The :class:`ModelRegistry` owns the name -> spec table and the
**generation counter** per model: every hot reload
(:func:`..serving.reload.hot_swap`) bumps the model's generation
atomically with the backend swap, and every gateway response is tagged
with the generation that produced it, so "no in-flight request ever
mixes weights across versions" is checkable per response.

Registry format (``describe()``)::

    {"mnist": {"kind": "fn", "item_shape": [784], "dtype": "float32",
               "buckets": [1, 2, 4, 8], "weight": 2.0,
               "deadline_classes": [["interactive", 50.0],
                                    ["batch", null]],
               "quantize": "int8", "mesh_axes": null,
               "slo": [0.99, 0.25], "generation": 3}}
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd
from ..cached_op import CachedOp
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .buckets import BucketPolicy
from .engine import _CheckpointModel, _FnModel, held_bytes

__all__ = ["ModelSpec", "ModelRegistry", "QuantizedFnModel",
           "MeshShardedModel"]

_QUANT_MODES = (None, "int8", "bf16")


class ModelSpec:
    """Declarative description of one served model.

    Parameters
    ----------
    name : str
        Registry key; also the ``model=`` label on every
        ``mx_serving_gateway_*`` series.
    fn : callable(*params, data), optional
        Pure eval-time forward. Mutually exclusive with ``checkpoint``.
    params : sequence of NDArray/ndarray
        Leading arguments bound to ``fn`` (version 1's weights; hot
        reloads supply later versions).
    checkpoint : str, optional
        ``model.save_checkpoint`` prefix; with ``epoch`` selects the
        served version. Mutually exclusive with ``fn``.
    epoch : int
        Checkpoint epoch (default 0).
    item_shape : tuple
        Per-example shape WITHOUT the batch dim.
    dtype : input dtype (default float32).
    max_batch, buckets : the bucket ladder (:class:`BucketPolicy`).
    weight : float
        Fair-share weight for the gateway's weighted round-robin —
        relative device-time share under contention (default 1).
    deadline_classes : sequence of (class_name, timeout_ms), optional
        Ordered HIGHEST priority first. A request names its class at
        ``submit()`` and inherits the class deadline unless it passes
        an explicit ``timeout_ms``; when the model's SLO burn rate
        exceeds budget the gateway sheds the LOWEST (last) class at
        admission. Default: one class ``("default", default_timeout_ms)``.
    default_timeout_ms : float, optional
        Deadline of the implicit single class (None = never expires).
    quantize : None | "int8" | "bf16"
        fn-model execution variant: ``int8`` = weight-only per-tensor
        symmetric quantization (matrices stored int8, dequantized
        in-graph via ``ops/quantization_ops``); ``bf16`` = params and
        compute in bfloat16, outputs cast back to fp32.
    mesh_axes : dict, optional
        fn-model execution variant: the params split over
        ``parallel.make_mesh(mesh_axes)``, a mesh over the ranks of the
        process group, by the Megatron-style default rule (batch and
        outputs replicated): each rank holds its block, and every call
        gathers the full weights (:class:`MeshShardedModel`).
        Incompatible with ``quantize`` and ``checkpoint``.
    slo : (objective, threshold_s), optional
        Latency SLO over this model's gateway latency series, e.g.
        ``(0.99, 0.250)``; drives SLO-coupled shedding.
    decode : DecodeConfig or dict, optional
        Marks a CONTINUOUS-BATCHING sequence model
        (:mod:`.continuous`): the decode step/prefill functions and the
        paged-state shape. Mutually exclusive with ``fn``/``checkpoint``
        (the step IS the model); ``max_batch``/``buckets`` become the
        decode slot ladder and ``item_shape`` is not required. Requests
        route through ``gateway.submit_sequence``.
    max_delay_ms : float, optional
        Per-model micro-batching window override: this model's queue
        flushes after at most this long even when the gateway-wide
        window (``ModelGateway(max_delay_ms=)``) is longer — the
        latency-class escape hatch. Default None = gateway window.
    queue_share : float in (0, 1], optional
        Cap on this model's share of the gateway admission pool: it may
        queue at most ``ceil(queue_share * max_queue)`` requests, so one
        hot model cannot fill the whole pool before fair-share kicks
        in. Default None = bounded only by the pool.
    data_name : checkpoint models' data input name (default "data").
    ctx : device context for backend calls (default: the gateway's, set
        at registration; the current context for a spec built alone).
    """

    def __init__(self, name, *, fn=None, params=(), checkpoint=None,
                 epoch=0, item_shape=None, dtype="float32", max_batch=32,
                 buckets=None, weight=1.0, deadline_classes=None,
                 default_timeout_ms=None, quantize=None, mesh_axes=None,
                 slo=None, decode=None, max_delay_ms=None,
                 queue_share=None, data_name="data", ctx=None):
        if decode is not None:
            if fn is not None or checkpoint is not None:
                raise ValueError("a decode model's step function rides "
                                 "decode=; fn=/checkpoint= must be None")
            if quantize or mesh_axes is not None:
                raise ValueError("decode= is incompatible with "
                                 "quantize=/mesh_axes= (wrap the step "
                                 "function instead)")
            from .continuous import DecodeConfig

            if isinstance(decode, dict):
                decode = DecodeConfig(**decode)
            if not isinstance(decode, DecodeConfig):
                raise ValueError("decode= must be a DecodeConfig or its "
                                 "kwargs dict, got %r" % (decode,))
        else:
            if (fn is None) == (checkpoint is None):
                raise ValueError("pass exactly one of fn= or checkpoint=")
            if item_shape is None:
                raise ValueError("item_shape is required for batch "
                                 "(non-decode) models")
        if quantize not in _QUANT_MODES:
            raise ValueError("quantize must be one of %r, got %r"
                             % (_QUANT_MODES, quantize))
        if quantize and checkpoint is not None:
            raise ValueError("quantize= needs an fn model (checkpoint "
                             "symbols keep their trained dtypes)")
        if mesh_axes is not None and (checkpoint is not None or quantize):
            raise ValueError("mesh_axes= needs a plain fn model")
        self.name = str(name)
        self.fn = fn
        self.params = list(params)
        self.checkpoint = checkpoint
        self.epoch = int(epoch)
        self.decode = decode
        self.item_shape = tuple(item_shape) if item_shape is not None \
            else None
        self.dtype = np.dtype(dtype)
        self.policy = BucketPolicy(max_batch=max_batch, buckets=buckets)
        self.max_delay_ms = None if max_delay_ms is None \
            else float(max_delay_ms)
        if self.max_delay_ms is not None and self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0, got %r"
                             % (max_delay_ms,))
        self.queue_share = None if queue_share is None \
            else float(queue_share)
        if self.queue_share is not None \
                and not 0.0 < self.queue_share <= 1.0:
            raise ValueError("queue_share must be in (0, 1], got %r"
                             % (queue_share,))
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("weight must be > 0, got %r" % (weight,))
        if deadline_classes is None:
            deadline_classes = (("default", default_timeout_ms),)
        items = list(deadline_classes.items()
                     if isinstance(deadline_classes, dict)
                     else deadline_classes)
        if not items:
            raise ValueError("deadline_classes must not be empty")
        self.classes = tuple((str(c), None if t is None else float(t))
                             for c, t in items)
        self.class_timeouts = dict(self.classes)
        if len(self.class_timeouts) != len(self.classes):
            raise ValueError("duplicate deadline class names: %r"
                             % (self.classes,))
        self.default_class = self.classes[0][0]
        self.lowest_class = self.classes[-1][0]
        self.quantize = quantize
        self.mesh_axes = dict(mesh_axes) if mesh_axes is not None else None
        self.slo = (float(slo[0]), float(slo[1])) if slo is not None \
            else None
        self.data_name = data_name
        self.ctx = ctx

    # -- backend construction --------------------------------------------------

    def build_backend(self, params=None, checkpoint=None, epoch=None):
        """Build a fresh backend for this spec — version 1 at
        registration, or a NEW version for a hot reload (``params=`` for
        fn models, ``checkpoint=``/``epoch=`` for checkpoint models).
        The returned object is ``__call__(batch NDArray) -> NDArray``
        (or tuple) with ``compile_count`` and ``held_bytes`` properties,
        and owns its own signature cache: swapping backends swaps every
        signature. Decode specs build a
        :class:`.continuous._DecodeBackend` (the paged state buffers plus
        the step, place and prefill CachedOps) instead."""
        if self.decode is not None:
            if checkpoint is not None or epoch is not None:
                raise ValueError("model %r is a decode model: reload it "
                                 "with params=, not checkpoint="
                                 % self.name)
            from .continuous import _DecodeBackend

            pvals = self.params if params is None else list(params)
            return _DecodeBackend(self.decode, pvals, name=self.name,
                                  policy=self.policy, ctx=self.ctx)
        if self.fn is not None:
            if checkpoint is not None or epoch is not None:
                raise ValueError("model %r is an fn model: reload it "
                                 "with params=, not checkpoint="
                                 % self.name)
            pvals = self.params if params is None else list(params)
            if self.mesh_axes is not None:
                return MeshShardedModel(self.fn, pvals, self.mesh_axes,
                                        name=self.name, ctx=self.ctx)
            if self.quantize:
                return QuantizedFnModel(self.fn, pvals, self.quantize,
                                        ctx=self.ctx)
            return _FnModel(self.fn, pvals, ctx=self.ctx)
        if params is not None:
            raise ValueError("model %r is a checkpoint model: reload it "
                             "with checkpoint=/epoch=, not params="
                             % self.name)
        from .. import model as _model

        prefix = checkpoint if checkpoint is not None else self.checkpoint
        ep = self.epoch if epoch is None else int(epoch)
        ctx = self.ctx if self.ctx is not None else current_context()
        symbol, arg_params, aux_params = _model.load_checkpoint(prefix, ep,
                                                                ctx=ctx)
        return _CheckpointModel(symbol, arg_params, aux_params,
                                data_name=self.data_name, ctx=ctx)

    def describe(self):
        return {
            "kind": "decode" if self.decode is not None
            else "fn" if self.fn is not None else "checkpoint",
            "item_shape": list(self.item_shape)
            if self.item_shape is not None else None,
            "dtype": str(self.dtype),
            "buckets": list(self.policy.buckets),
            "weight": self.weight,
            "deadline_classes": [[c, t] for c, t in self.classes],
            "quantize": self.quantize,
            "mesh_axes": self.mesh_axes,
            "slo": list(self.slo) if self.slo else None,
            "decode": self.decode.describe()
            if self.decode is not None else None,
            "max_delay_ms": self.max_delay_ms,
            "queue_share": self.queue_share,
        }


class ModelRegistry:
    """Thread-safe name -> (spec, generation) table.

    The generation counter is the version authority for hot reloads:
    :meth:`bump` is called under the gateway's swap lock, so a response
    tagged generation N was produced by exactly the N-th committed
    version of that model's weights."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs = {}
        self._gens = {}

    def register(self, spec):
        with self._lock:
            if spec.name in self._specs:
                raise ValueError("model %r already registered" % spec.name)
            self._specs[spec.name] = spec
            self._gens[spec.name] = 1
        return spec

    def unregister(self, name):
        with self._lock:
            spec = self._specs.pop(name, None)
            self._gens.pop(name, None)
        if spec is None:
            raise KeyError("model %r is not registered" % (name,))
        return spec

    def spec(self, name):
        with self._lock:
            spec = self._specs.get(name)
        if spec is None:
            raise KeyError("model %r is not registered (have: %s)"
                           % (name, sorted(self._specs) or "none"))
        return spec

    def names(self):
        with self._lock:
            return sorted(self._specs)

    def generation(self, name):
        with self._lock:
            return self._gens[name]

    def bump(self, name):
        """Commit a new version: returns the NEW generation."""
        with self._lock:
            self._gens[name] += 1
            return self._gens[name]

    def describe(self):
        """JSON-able registry view (the documented registry format)."""
        with self._lock:
            items = [(n, s, self._gens[n])
                     for n, s in sorted(self._specs.items())]
        return {n: dict(s.describe(), generation=g) for n, s, g in items}


# -- execution variants --------------------------------------------------------

def _floating(p):
    return p._data.is_floating_point()


class QuantizedFnModel:
    """Weight-quantized fn backend on the same CachedOp bucket core.

    ``int8``: every floating matrix param (ndim >= 2) is quantized ONCE
    at build with a per-tensor symmetric range (the
    ``ops/quantization_ops`` int8 pipeline) and stored int8 on its
    device; the served function dequantizes it on each call (the
    reference's quantized-inference memory shape). Vectors and scalars
    (biases, BatchNorm statistics) stay float32. ``bf16``: float params
    cast to bfloat16 once, the input cast inside the function, outputs
    cast back to float32. Both run one CachedOp signature per bucket.
    NDArray params stay on their device; others are placed on `ctx`."""

    def __init__(self, fn, params, mode, ctx=None):
        if mode not in ("int8", "bf16"):
            raise ValueError("quantize mode must be int8|bf16, got %r"
                             % (mode,))
        ctx = ctx if ctx is not None else current_context()
        self.mode = mode
        params = [p if isinstance(p, NDArray) else nd.array(p, ctx=ctx)
                  for p in params]
        inner = fn

        if mode == "bf16":
            flat = [p.astype("bfloat16") if _floating(p) else p
                    for p in params]
            n = len(flat)

            def wrapped(*args):
                ps, x = args[:n], args[n]
                out = inner(*ps, x.astype("bfloat16"))
                outs = out if isinstance(out, (list, tuple)) else (out,)
                outs = tuple(o.astype("float32") if _floating(o) else o
                             for o in outs)
                return outs if len(outs) > 1 else outs[0]
        else:
            entries, flat = [], []
            for p in params:
                if _floating(p) and p.ndim >= 2:
                    amax = float(np.abs(p.asnumpy()).max()) or 1.0
                    mn = nd.array(np.array([-amax], np.float32),
                                  ctx=p.context)
                    mx = nd.array(np.array([amax], np.float32),
                                  ctx=p.context)
                    q, _, _ = nd._contrib_quantize(p, mn, mx)
                    entries.append(("q", len(flat)))
                    flat.extend([q, mn, mx])
                else:
                    entries.append(("raw", len(flat)))
                    flat.append(p)
            n = len(flat)

            def wrapped(*args):
                stored, x = args[:n], args[n]
                ps = []
                for kind, i in entries:
                    if kind == "q":
                        ps.append(nd._contrib_dequantize(
                            stored[i], stored[i + 1], stored[i + 2]))
                    else:
                        ps.append(stored[i])
                return inner(*ps, x)

        self._params = flat
        # int8: [(kind, index into _params)], "q" an int8 matrix whose
        # two ranges follow it, "raw" a param kept as given.
        self.entries = entries if mode == "int8" else None
        self._cached = CachedOp(wrapped, num_params=len(flat))

    def __call__(self, batch):
        return self._cached.inference(*(self._params + [batch]))

    @property
    def compile_count(self):
        return self._cached.num_traces

    @property
    def held_bytes(self):
        """Bytes of the stored params (int8 matrices and their ranges,
        or the bfloat16 casts)."""
        return held_bytes(self._params)


class MeshShardedModel:
    """fn backend whose params are split over a mesh of ranks: each rank
    holds its block of every param that ``parallel.mesh.shard_params``'s
    rule (the Megatron-style tp default, or `param_rule`) splits
    (``parallel.mesh.place``), and each call gathers the full weights
    (``parallel.collectives.gather``) and runs `fn` on the replicated
    batch, in eval mode with no autograd graph.

    The port runs one device per process, so ``mesh_axes`` spans the
    process group: ``{"tp": 2}`` needs a group of 2
    (``parallel.dist.initialize``), and axes whose product differs from
    the group's size raise ValueError (a -1 axis takes every rank). There
    is no unsharded fallback.

    Multi-process contract: every rank calls the backend in LOCKSTEP
    with the same data (each call's gather is a collective), the
    TrainStep discipline. ``compile_count`` is the number of batch
    shapes seen (the bucket contract)."""

    def __init__(self, fn, params, mesh_axes, name="mesh", param_rule=None,
                 ctx=None):
        from ..parallel import dist
        from ..parallel.mesh import make_mesh, place, shard_params

        axes = dict(mesh_axes)
        sizes = [int(s) for s in axes.values()]
        world = dist.num_processes()
        if -1 not in sizes and math.prod(sizes) != world:
            raise ValueError(
                "mesh_axes %r of model %r spans %d ranks, but the process "
                "group has %d: the port runs one device per process, so "
                "start %d ranks (parallel.launch) and call "
                "parallel.dist.initialize() first"
                % (axes, name, math.prod(sizes), world, math.prod(sizes)))
        if dist.is_initialized():
            self.mesh = make_mesh(axes)
        else:
            dev = ctx if ctx is not None else current_context()
            self.mesh = make_mesh(axes, devices=[dev])
        self.name = name
        self._fn = fn
        full = [(p._data if isinstance(p, NDArray)
                 else torch.as_tensor(np.asarray(p))) for p in params]
        named = {"p%d" % i: tuple(t.shape) for i, t in enumerate(full)}
        shardings = shard_params(self.mesh, named, rule=param_rule)
        self.param_shardings = [shardings["p%d" % i]
                                for i in range(len(full))]
        self._param_vals = [place(t, s)
                            for t, s in zip(full, self.param_shardings)]
        self._shapes = set()

    def __call__(self, batch):
        from ..parallel import collectives

        ctx = self.mesh.context
        x = batch._data if isinstance(batch, NDArray) \
            else torch.as_tensor(np.asarray(batch))
        x = x.to(self.mesh.device)
        self._shapes.add(tuple(x.shape))
        with torch.no_grad(), autograd.pause(train_mode=False):
            full = collectives.gather(self._param_vals,
                                      self.param_shardings)
            return self._fn(*([NDArray(p, ctx=ctx) for p in full]
                              + [NDArray(x, ctx=ctx)]))

    @property
    def compile_count(self):
        # one signature per observed batch shape (the bucket contract)
        return len(self._shapes)

    @property
    def held_bytes(self):
        """Bytes of this rank's blocks."""
        return held_bytes(self._param_vals)
