"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py — Trainer, step/allreduce_grads/update,
save_states/load_states), on the single-context path: the usual MXNet
training loop ::

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

A Trainer over parameters that live on more than one context raises,
and so does a ``dist_*`` kvstore: the multi-context reduce (the
kvstore-backed ``allreduce_grads``, the bucketed and overlapped
pipelines, update-on-kvstore) is ROADMAP Queue 1 item 7. The JAX
package creates no kvstore for a single context either, so on one
context the two Trainers take the same path. The numeric grad guard
is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import math
import time

import torch

from .. import env as _env
from .. import optimizer as opt
from ..checkpoint import guard as _guard
from ..ops import optimizer_ops as _oo
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import xtrace as _xtrace
from .parameter import ParameterDict

__all__ = ["Trainer"]

_update_seconds = _tm.REGISTRY.histogram(
    "mx_trainer_update_seconds",
    "Trainer._update wall time (host dispatch path, fused or loop)")


def _multi_context(what):
    return NotImplementedError(
        "%s: the port's Trainer runs on one context; the multi-context "
        "reduce (kvstore allreduce, gradient buckets, the overlapped and "
        "update-on-kvstore pipelines) and dist_* stores are ROADMAP "
        "Queue 1 item 7" % what)


def _gn_sumsq(grad):
    """fp32 sum of squares of one gradient tensor (the per-param half
    of the global-norm clip; low-precision grads widen first)."""
    g32 = grad if grad.dtype == torch.float32 else grad.to(torch.float32)
    return (g32 * g32).sum()


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    gluon/trainer.py:Trainer).

    Parameters
    ----------
    params : ParameterDict, dict or list of Parameters.
    optimizer : name or :class:`~mxnet_tpu_torch.optimizer.Optimizer`.
    optimizer_params : dict of the optimizer's keyword arguments.
    kvstore : ``"device"``/``"local"``/None or a single-device KVStore;
        with one context no store is created (as in the JAX package).
        ``dist_*`` raises (ROADMAP Queue 1 item 7).
    compression_params : accepted; used only by a multi-context store.
    update_on_kvstore : None or False (True needs a multi-context or
        dist store and raises ValueError, as in the JAX package).
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
        self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_type = kvstore
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._check_kvstore()
        self._fused = bool(_env.get("MXNET_FUSED_UPDATE")) \
            if fused is None else bool(fused)
        from .. import fused_update as _fu

        self._applier = _fu.FusedApplier(self._updater)
        self._global_norm_clip = (None if global_norm_clip is None
                                  else float(global_norm_clip))
        if self._global_norm_clip is not None and \
                self._global_norm_clip <= 0:
            raise ValueError("global_norm_clip must be positive")

    def _check_contexts(self):
        contexts = None
        for p in self._params:
            if p._data is None:
                continue
            ctx = p.list_ctx()
            if len(ctx) > 1:
                raise _multi_context(
                    "Parameter %r lives on %d contexts %s"
                    % (p.name, len(ctx), ctx))
            if contexts is None:
                contexts = ctx
        return contexts or []

    def _check_kvstore(self):
        kv = self._kvstore_type
        name = kv.type if hasattr(kv, "type") else str(kv or "")
        if "dist" in name:
            raise _multi_context("kvstore %r" % name)

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
        """The JAX package creates a store only for several contexts or a
        dist_* type (reference trainer.py:_init_kvstore); the port has
        neither, so this only validates."""
        self._check_contexts()
        if self._update_on_kvstore:
            raise ValueError(
                "update_on_kvstore=True requires a kvstore (multi-context "
                "or dist_*); this trainer has %d context(s) and kvstore=%r"
                % (len(self._check_contexts()), self._kvstore_type))
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
        ctx = _xtrace.current()
        with _xtrace.activate(ctx if ctx is not None
                              else _xtrace.new_root()):
            self._optimizer.rescale_grad = self._scale / batch_size
            if not self._kv_initialized:
                self._init_kvstore()
            self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce gradients across contexts: nothing to do on one."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Apply the optimizer once per parameter. Fused path (default):
        dense parameters of a supported family go through one pass per
        chunk of a (context, dtype) group, bit for bit the loop's update;
        the rest takes the per-parameter loop."""
        t0 = time.perf_counter()
        work = []
        for i, p in enumerate(self._params):
            if p._grad_req == "null" or p._data is None:
                continue
            if len(p._data) > 1:
                raise _multi_context("Parameter %r" % p.name)
            work.append((i, next(iter(p._data.values())),
                         next(iter(p._grad.values()))))
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
                         params=len(work)), _guard.updating():
            if self._fused and work:
                pending = self._applier.apply(work, grad_scale=scale)
            else:
                pending = work
            for i, w, g in pending:
                if scale is not None and scale != 1.0:
                    # Rounded to the gradient dtype, as the fused apply
                    # rounds its runtime scale.
                    g = g * _oo._c(scale, g._data.dtype)
                self._updater(i, g, w)
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
