"""The whole training step: forward, loss, backward and optimizer update.

Counterpart of ``mxnet_tpu/parallel/train_step.py``. The JAX package
traces the step into one XLA executable; PyTorch runs it eagerly, in the
same order and with the same arithmetic:

1. The net runs in train mode with recording paused
   (``autograd.is_recording()`` is False inside it, as under the
   reference's ``pause(train_mode=True)``), on copies of the parameters
   passed through ``parameter.override``. BatchNorm normalises with the
   batch statistics; its running-stat writes are captured, not applied.
2. The loss is the **mean** of the per-sample loss, and the gradient is
   that mean's, taken with ``torch.autograd.grad`` with respect to the
   fp32 master weights of the trainable parameters (``grad_req`` not
   ``"null"``). The other parameters are aux state.
3. Each master is updated by the optimizer's update op
   (``ops/optimizer_ops.py``) with the learning rate as a runtime value
   and the step counter ``t = num_update + 1``. Weight decay applies to
   every trainable parameter, biases and BatchNorm gamma/beta included.
4. The captured running statistics are committed, cast back to their
   stored dtype.

Under ``dtype="bfloat16"`` the masters and the optimizer state stay fp32.
The parameters and ``x`` are cast to bf16 inside the step, aux state
stays fp32, the net's output is cast to fp32 before the loss (a compute
dtype of fp32 or wider keeps its own), and the gradients reach the
update in fp32 through the casts.

Where the JAX package donates the step's buffers to XLA, the port
updates the masters, the optimizer state and the aux state in place,
under ``torch.no_grad()``. The net's own parameters keep their values
until :meth:`TrainStep.sync_to_net`, as in the reference.

Every optimizer family of the JAX TrainStep runs here: sgd, nag,
signum, signsgd, adam, rmsprop (plain and centered), adagrad, adadelta,
ftrl, ftml, nadam, dcasgd, sgld and lbsgd, over the bodies of
``ops/optimizer_ops.py`` (the rules of
``mxnet_tpu/parallel/train_step.py:160-262``, with the same defaults as
the optimizer classes). Two differ in their arithmetic, not their
formula: Adam's bias-corrected step size ``lr * sqrt(1 - beta2**t) /
(1 - beta1**t)`` is computed in Python floats (the JAX package computes
it in fp32 inside its traced step), and SGLD draws its noise from the
port's per-device generator (``random.generator``).

Checkpointing (``state_dict``/``load_state_dict`` for
``mxnet_tpu_torch.checkpoint``, ``save_checkpoint``/``load_checkpoint``
in the ``.params`` wire format) keeps the JAX package's keys. The
update loop writes the masters and states in place, one tensor at a
time, so it runs inside ``checkpoint.guard.updating()`` with the step
counter's bump: a snapshot raises there instead of mixing two steps.
The RNG entry holds the port's own position (root seed, host counter
and every device generator's state, ``random.get_state``); the JAX
package's counter means nothing to a ``torch.Generator``, so a state of
the other package restores everything but its RNG entry, which is
ignored with a warning.

Data parallelism over ranks (``mesh`` from ``make_mesh`` after
``parallel.dist.initialize``): each rank feeds its local slice of the
global batch (``dist.local_slice``), as in the JAX package
(``train_step.py:606-640`` there), and the step computes what the JAX
package's GSPMD step computes over the global batch. The loss is the
mean over the global batch: each rank differentiates its local mean
times its share ``local_n / global_n``, and the gradients are summed
over the ``dp`` group (one ``all_reduce`` per dtype). Train-mode
BatchNorm normalises with the global batch's statistics
(``ops.nn.batch_stat_reducer``: the local mean and variance combined
by a differentiable all-reduce), as ``jnp.mean`` over a sharded batch
axis is global under GSPMD, so the running-stat writes are the same on
every rank. At one rank every share is 1 and every sum is over one
value, so the step gives the single-device step's bits.

Tensor parallelism (a mesh over ranks with a ``tp`` axis larger than
1): each trainable parameter is placed by ``shard_params``'s rule (the
JAX package's Megatron rule, ``param_rule`` to override it), and each
rank keeps only its block of a split parameter (``mesh.place``) and of
its optimizer state, which is sized by the block. The batch is split
over ``dp`` only (``mesh.local_slice``), so the ranks of a ``tp`` group
feed the same rows. In the forward each split parameter enters as
``collectives.gather`` of its block, cast to the compute dtype first
(the cast is elementwise, so it gives the same values, in half the bytes
under bf16); the gather's backward hands each rank its block of the
full gradient, which the ``dp`` all-reduce then sums over the group.
BatchNorm's global statistics stay over ``dp``. Then, along each other
axis, the rank at index 0 broadcasts the loss, the gradients of the
parameters not split over that axis and the new aux values
(``_sync_replicas``): a replicated parameter, its optimizer state and
the aux state stay one array by construction, even where the ranks'
forwards and backwards differ in their last bits (cuDNN's default
algorithms are not deterministic). The update is local and
elementwise on the block, except lbsgd's trust ratio, which takes the
norms of the whole weight and gradient: their sums of squares are added
over the axis groups first (``collectives.sq_sum``), so lbsgd agrees
with the dp step to rounding, not bit for bit. SGLD draws each block's
noise from its rank's own stream (``random.set_rank``), as the dp step
draws each rank's, so its replicas differ by their noise. Where every
rank's arithmetic is deterministic (cuDNN's deterministic algorithms,
as on the host), every other family gives the bits of the dp step on
the same global batch: the forward sees the same full weights, and a
block of a sum over ``dp`` is the sum of the blocks. Axes other than
``dp`` and ``tp`` (``sp``, ``ep``, ``pp``) of size larger than 1
replicate the parameters and the batch, as in the JAX step, unless the
rule splits over them. A rule that splits a parameter over ``dp``
itself is honored: that parameter's gradient is summed over ``dp`` in
the gather's backward and left out of the ``dp`` all-reduce.

``deterministic_reduction=True`` (the JAX package's
``_make_deterministic_grad``): per-shard loss, gradients and
per-shard BatchNorm statistics, gathered (``collectives.gather_slots``)
and summed in ascending rank order, divided by the ``dp`` size; dp-only
meshes. The random streams differ per rank (``random.set_rank``), so a
comparison with the JAX package's step, which draws one key for the
global batch, uses nets without dropout.

Telemetry, as in the JAX package: the step runs inside the ``step``
heartbeat lane of the hang watchdog; the ``train_step::data_put``,
``train_step::dispatch`` (forward, backward, all-reduce and update
enqueued) and ``train_step::step`` spans, ``mx_train_step_seconds`` and
``mx_train_steps_total`` record each step; the first step is observed
as ``mx_compile_seconds{site="train_step"}`` and flips the step's
health-plane readiness slot (``/readyz``) to ready. With
``telemetry.attribution.set_device_spans(True)`` (a ``StepAttribution``
turns it on) a ``train_step::device`` span follows the dispatch: a
CUDA event recorded after the step's work and synchronised, so it ends
when the card has finished the step (the JAX package's
``jax.block_until_ready``); with device spans off nothing waits. The
JAX package loads the step's executable from its compile cache; the
step here runs eagerly and has no executable to store: the port's
compile cache (``compile/``) holds the kernels nvcc and NVRTC build.
"""
from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from .. import autograd
from .. import profiler as _profiler
from .. import random as _random
from ..checkpoint import guard as _guard
from ..telemetry import attribution as _attr
from ..telemetry import healthplane as _hp
from ..telemetry import memstats as _ms
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..telemetry import watchdog as _watchdog
from ..base import torch_dtype
from ..gluon.parameter import override
from ..ndarray.ndarray import NDArray
from ..ops import nn as _nn_ops
from . import collectives as _coll
from . import dist as _dist
from .mesh import (make_mesh, data_sharding, shard_params, place,
                   NamedSharding, P)

_step_seconds = _tm.REGISTRY.histogram(
    "mx_train_step_seconds",
    "TrainStep.__call__ wall time (host dispatch path)")
_steps_total = _tm.REGISTRY.counter(
    "mx_train_steps_total", "Completed TrainStep calls")

__all__ = ["TrainStep"]



def _as_pair(res):
    """(new_weight, single_state) -> (new_weight, (single_state,))."""
    w, s = res
    return w, (s,)


def _as_tensor(a):
    if isinstance(a, NDArray):
        return a._data.detach()
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.ascontiguousarray(a)
    # float64 host data computes in the default real type, as jnp.asarray
    # gives it in the reference.
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                            else a)


class TrainStep:
    """Run `net` + `loss_fn` + optimizer as one training step.

    Parameters
    ----------
    net : initialized gluon Block (deferred shapes are inferred by one
        forward at the first call). TrainStep takes copies of its values.
    loss_fn : callable (pred NDArray, label NDArray) -> per-sample loss.
    optimizer : family name: sgd, nag, signum, signsgd, adam, rmsprop,
        adagrad, adadelta, ftrl, ftml, nadam, dcasgd, sgld or lbsgd.
    optimizer_params : dict — learning_rate, momentum, wd, beta1, beta2,
        epsilon, rescale_grad, clip_gradient and the family's own knobs
        (gamma1, rho, lamda1, ...). The learning rate is a runtime value
        (:meth:`set_learning_rate`).
    mesh : :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` of one device, or
        over the ranks of the process group with a ``dp`` axis and any
        others (``tp``, ``sp``, ``ep``, ``pp``) (default: ``make_mesh()``:
        the group's ranks after ``dist.initialize``, else the one card).
    param_rule : ``rule(name, shape, mesh) -> P`` placing each trainable
        parameter (default: ``shard_params``'s Megatron rule, which
        splits large weights over ``tp``).
    dtype : compute dtype for mixed precision (``"bfloat16"``); masters
        and optimizer state stay fp32.
    deterministic_reduction : per-shard gradients summed in ascending
        rank order (dp-only meshes); see the module docstring.
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rule=None, dtype=None,
                 deterministic_reduction=False):
        self.deterministic_reduction = bool(deterministic_reduction)
        self.net = net
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else make_mesh()
        opt_params = dict(optimizer_params or {})
        self._explicit = frozenset(opt_params)
        self.lr = float(opt_params.pop("learning_rate", 0.01))
        self.optimizer = optimizer
        self.momentum = float(opt_params.pop("momentum", 0.0))
        # Defaults match the optimizer classes, so Trainer and TrainStep
        # train alike on the same optimizer_params.
        self.wd = float(opt_params.pop("wd", 0.0))
        self.beta1 = float(opt_params.pop("beta1", 0.9))
        self.beta2 = float(opt_params.pop("beta2", 0.999))
        self.epsilon = float(opt_params.pop("epsilon", 1e-8)) \
            if "epsilon" in opt_params else None
        self.rescale_grad = float(opt_params.pop("rescale_grad", 1.0))
        clip = opt_params.pop("clip_gradient", None)
        self.clip_gradient = None if clip is None else float(clip)
        # The rest is family-specific (gamma1, rho, lamda1, ...).
        self._opt_extra = opt_params
        self._opt_init = None          # custom state init (e.g. DCASGD)
        self._opt_n_states, self._opt_update = self._make_opt_rule()
        self.num_update = 0
        self._dtype = None if dtype is None else torch_dtype(dtype)
        self._device = self.mesh.device
        self._data_sharding = data_sharding(self.mesh)
        self._param_rule = param_rule
        self._dp_group = self._check_mesh()
        self._shardings = {}
        self._shapes = {}
        self._materialized = False
        self._hp_component = None      # health-plane readiness slot
        self._hp_ready = False
        self._first_step_pending = True

    def _check_mesh(self):
        """The ``dp`` group of a mesh over ranks (None on one device);
        raises for an inconsistent mesh, and for
        ``deterministic_reduction`` on a mesh with another axis larger
        than 1, as the JAX package does."""
        mesh = self.mesh
        mesh.validate()
        for ax in mesh.axis_names:
            if ax != "dp" and mesh.shape[ax] != 1 and \
                    self.deterministic_reduction:
                raise ValueError(
                    "deterministic_reduction supports dp-only meshes; "
                    "got axis %r of size %d" % (ax, mesh.shape[ax]))
        if not getattr(mesh, "over_ranks", False):
            return None
        if "dp" not in mesh.axis_names:
            raise ValueError("a TrainStep over ranks needs a 'dp' axis; "
                             "mesh %s" % (mesh.shape,))
        return mesh.group("dp")

    def _make_opt_rule(self):
        """(n_states, update_fn(param, grad, states, lr, t, split) ->
        (new_param, new_states)) over the bodies of ops/optimizer_ops.py:
        the bodies the Trainer's update ops run. `split` is the
        parameter's sharding where it is split across ranks, else None
        (lbsgd's norms read it)."""
        from ..ops import optimizer_ops as oo
        from .. import random as _random

        name = self.optimizer.lower()
        mom, wd, rs = self.momentum, self.wd, self.rescale_grad
        clip = -1.0 if self.clip_gradient is None else self.clip_gradient
        b1, b2 = self.beta1, self.beta2
        ex = self._opt_extra

        def eps(default):
            return self.epsilon if self.epsilon is not None else default

        def check_extra(*allowed):
            unknown = set(ex) - set(allowed)
            if unknown:
                raise ValueError(
                    "TrainStep(%s) got unsupported optimizer_params %s"
                    % (name, sorted(unknown)))

        def f32(v):
            return torch.zeros_like(v, dtype=torch.float32,
                                    requires_grad=False)

        if name in ("sgd", "nag"):
            check_extra()
            if mom > 0:
                body = oo._sgd_mom_update if name == "sgd" \
                    else oo._nag_mom_update
                return 1, lambda p, g, s, lr, t, split: _as_pair(
                    body(p, g, s[0], lr=lr, momentum=mom, wd=wd,
                         rescale_grad=rs, clip_gradient=clip))
            return 0, lambda p, g, s, lr, t, split: (
                oo._sgd_update(p, g, lr=lr, wd=wd, rescale_grad=rs,
                               clip_gradient=clip), ())
        if name in ("signum", "signsgd"):
            check_extra("wd_lh")
            # Signum defaults to momentum 0.9, SignSGD to 0.0; an
            # explicit momentum wins for both.
            if "momentum" in self._explicit:
                sig_mom = mom
            else:
                sig_mom = 0.9 if name == "signum" else 0.0
            wd_lh = float(ex.get("wd_lh", 0.0))
            if sig_mom > 0:
                return 1, lambda p, g, s, lr, t, split: _as_pair(
                    oo._signum_update(p, g, s[0], lr=lr, momentum=sig_mom,
                                      wd=wd, rescale_grad=rs,
                                      clip_gradient=clip, wd_lh=wd_lh))
            return 0, lambda p, g, s, lr, t, split: (
                oo._signsgd_update(p, g, lr=lr, wd=wd, rescale_grad=rs,
                                   clip_gradient=clip), ())
        if name == "adam":
            check_extra()
            e = eps(1e-8)

            def adam(p, g, s, lr, t, split):
                lr_t = lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
                w, m, v = oo._adam_update(
                    p, g, s[0], s[1], lr=lr_t, beta1=b1, beta2=b2,
                    epsilon=e, wd=wd, rescale_grad=rs, clip_gradient=clip)
                return w, (m, v)

            return 2, adam
        if name == "rmsprop":
            check_extra("gamma1", "gamma2", "centered", "clip_weights")
            g1 = float(ex.get("gamma1", 0.9))
            g2 = float(ex.get("gamma2", 0.9))
            cw = float(ex.get("clip_weights", -1.0))
            e = eps(1e-8)
            if ex.get("centered", False):
                def rmsc(p, g, s, lr, t, split):
                    w, n, gb, d = oo._rmspropalex_update(
                        p, g, s[0], s[1], s[2], lr=lr, gamma1=g1,
                        gamma2=g2, epsilon=e, wd=wd, rescale_grad=rs,
                        clip_gradient=clip, clip_weights=cw)
                    return w, (n, gb, d)

                return 3, rmsc
            return 1, lambda p, g, s, lr, t, split: _as_pair(
                oo._rmsprop_update(p, g, s[0], lr=lr, gamma1=g1,
                                   epsilon=e, wd=wd, rescale_grad=rs,
                                   clip_gradient=clip, clip_weights=cw))
        if name == "adagrad":
            check_extra("eps")
            # AdaGrad spells its knob "eps"; "epsilon" is honored too.
            e = float(ex.get("eps", eps(1e-7)))
            return 1, lambda p, g, s, lr, t, split: _as_pair(
                oo._adagrad_update(p, g, s[0], lr=lr, epsilon=e, wd=wd,
                                   rescale_grad=rs, clip_gradient=clip))
        if name == "adadelta":
            check_extra("rho")
            rho = float(ex.get("rho", 0.90))
            e = eps(1e-5)

            def adad(p, g, s, lr, t, split):
                w, ag, ad = oo._adadelta_update(
                    p, g, s[0], s[1], rho=rho, epsilon=e, wd=wd,
                    rescale_grad=rs, clip_gradient=clip)
                return w, (ag, ad)

            return 2, adad
        if name == "ftrl":
            check_extra("lamda1", "beta")
            lam = float(ex.get("lamda1", 0.01))
            beta = float(ex.get("beta", 1.0))

            def ftrl(p, g, s, lr, t, split):
                w, z, n = oo._ftrl_update(
                    p, g, s[0], s[1], lr=lr, lamda1=lam, beta=beta,
                    wd=wd, rescale_grad=rs, clip_gradient=clip)
                return w, (z, n)

            return 2, ftrl
        if name == "ftml":
            check_extra()
            e = eps(1e-8)
            fb1 = self.beta1 if "beta1" in self._explicit else 0.6

            def ftml(p, g, s, lr, t, split):
                w, d, v, z = oo._ftml_update(
                    p, g, s[0], s[1], s[2], lr=lr, beta1=fb1, beta2=b2,
                    epsilon=e, wd=wd, rescale_grad=rs, clip_grad=clip,
                    t=t)
                return w, (d, v, z)

            return 3, ftml
        if name == "nadam":
            check_extra("schedule_decay")
            e = eps(1e-8)
            decay = float(ex.get("schedule_decay", 0.004))
            # The running schedule product is state starting at 1.0.
            self._opt_init = lambda v: (f32(v), f32(v), f32(v) + 1.0)

            def nadam(p, g, s, lr, t, split):
                mean, var, sched = s
                g = g * rs + wd * p
                if clip > 0:
                    g = g.clamp(-clip, clip)
                mom_t = b1 * (1.0 - 0.5 * 0.96 ** (t * decay))
                mom_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * decay))
                m_sched = sched * mom_t
                m_sched_next = m_sched * mom_t1
                mean = b1 * mean + (1.0 - b1) * g
                var = b2 * var + (1.0 - b2) * g * g
                g_prime = g / (1.0 - m_sched)
                m_prime = mean / (1.0 - m_sched_next)
                v_prime = var / (1.0 - b2 ** t)
                m_bar = (1.0 - mom_t) * g_prime + mom_t1 * m_prime
                w = p - lr * m_bar / (torch.sqrt(v_prime) + e)
                return w, (mean, var, m_sched)

            return 3, nadam
        if name == "dcasgd":
            check_extra("lamda")
            lam = float(ex.get("lamda", 0.04))
            # previous_weight starts AT the weight, as its own buffer.
            self._opt_init = lambda v: (
                f32(v), v.detach().to(torch.float32).clone())

            def dcasgd(p, g, s, lr, t, split):
                mom_s, prev = s
                g = g * rs
                if clip > 0:
                    g = g.clamp(-clip, clip)
                delta = -lr * (g + wd * p + lam * g * g * (p - prev))
                if mom > 0:
                    mom_s = mom * mom_s + delta
                    delta = mom_s
                # A copy: the step then writes p in place.
                return p + delta, (mom_s, p.to(torch.float32, copy=True))

            return 2, dcasgd
        if name == "sgld":
            check_extra()
            ctx = self.mesh.context

            def sgld(p, g, s, lr, t, split):
                g = g * rs
                if clip > 0:
                    g = g.clamp(-clip, clip)
                noise = torch.randn(
                    p.shape, generator=_random.generator(ctx),
                    device=p.device, dtype=p.dtype) * lr ** 0.5
                return p - lr / 2.0 * (g + wd * p) + noise, ()

            return 0, sgld
        if name == "lbsgd":
            # LARS-style trust-ratio scaling over SGD (optimizer.LBSGD);
            # the warmup knobs are accepted and advisory, as there.
            check_extra("warmup_strategy", "warmup_epochs", "batch_scale",
                        "updates_per_epoch", "begin_epoch", "num_epochs")

            def lars_lr(p, g, lr, split):
                if split is None:
                    wnorm = torch.linalg.vector_norm(p)
                    gnorm = torch.linalg.vector_norm(g) * rs
                else:
                    # A block of a split weight: the whole weight's norm.
                    wnorm = torch.sqrt(_coll.sq_sum(p, split))
                    gnorm = torch.sqrt(_coll.sq_sum(g, split)) * rs
                ratio = torch.clamp(
                    wnorm / (gnorm + wd * wnorm + 1e-9), max=10.0)
                return torch.where((wnorm > 0) & (gnorm > 0), lr * ratio,
                                   torch.full_like(ratio, lr))

            if mom > 0:
                return 1, lambda p, g, s, lr, t, split: _as_pair(
                    oo._sgd_mom_update(p, g, s[0],
                                       lr=lars_lr(p, g, lr, split),
                                       momentum=mom, wd=wd,
                                       rescale_grad=rs,
                                       clip_gradient=clip))
            return 0, lambda p, g, s, lr, t, split: (
                oo._sgd_update(p, g, lr=lars_lr(p, g, lr, split), wd=wd,
                               rescale_grad=rs, clip_gradient=clip), ())
        raise ValueError(
            "TrainStep supports sgd/nag/signum/signsgd/adam/rmsprop/"
            "adagrad/adadelta/ftrl/ftml/nadam/dcasgd/sgld/lbsgd (got %r);"
            " for other optimizers use gluon.Trainer" % self.optimizer)

    def _materialize(self, x_example):
        """Collect the parameters (inferring deferred shapes with one
        forward if needed) and place them on the mesh's device: this
        rank's block of each parameter the rule splits."""
        net = self.net
        params = list(net.collect_params().values())
        if any(p._data is None and p._deferred_init is not None
               for p in params):
            with autograd.pause():
                net(NDArray(x_example.to(self._device),
                            ctx=self.mesh.context))
            params = list(net.collect_params().values())
        self._train_params = [p for p in params if p.grad_req != "null"]
        self._aux_params = [p for p in params if p.grad_req == "null"]
        dev = self._device
        self._shapes = {p.name: tuple(p.shape) for p in self._train_params}
        self._shardings = shard_params(self.mesh, self._shapes,
                                       rule=self._param_rule)
        # Masters keep the parameter's own (fp32) dtype; they are leaves
        # of the step's graph, updated in place.
        self._param_vals = {
            p.name: place(p.data()._data, self._shardings[p.name])
            .requires_grad_(True) for p in self._train_params}
        self._aux_vals = {p.name: p.data()._data.detach().to(dev).clone()
                          for p in self._aux_params}
        k = self._opt_n_states
        init = self._opt_init or (lambda v: tuple(
            torch.zeros_like(v, dtype=torch.float32, requires_grad=False)
            for _ in range(k)))
        with torch.no_grad():
            self._opt_state = {n: init(v)
                               for n, v in self._param_vals.items()}
        self._materialized = True

    def _loss_and_grads(self, x, y, reducer=None, share=1.0):
        """(loss, {name: fp32 gradient}, {aux name: new value}) of the
        local batch: the loss is its mean times `share`, and `reducer`
        (``ops.nn.batch_stat_reducer``'s arguments) makes BatchNorm take
        global statistics."""
        cdt = self._dtype
        ctx = self.mesh.context

        def cast(a):
            return a.to(cdt) if cdt is not None and a.is_floating_point() \
                else a

        names = [p.name for p in self._train_params]
        # A split parameter enters as the gather of its cast block.
        full = _coll.gather([cast(self._param_vals[n]) for n in names],
                            [self._shardings[n] for n in names])
        mapping = {p: NDArray(v, ctx=ctx)
                   for p, v in zip(self._train_params, full)}
        # Aux (BatchNorm running stats) stays fp32: it sits only on the
        # moving-average path, so the moments accumulate in fp32.
        mapping.update({p: NDArray(self._aux_vals[p.name], ctx=ctx)
                        for p in self._aux_params})
        ov = override(mapping)
        stats = _nn_ops.batch_stat_reducer(*reducer) if reducer is not None \
            else contextlib.nullcontext()
        with autograd._differentiate(train_mode=True), ov, stats:
            out = self.net(NDArray(cast(x), ctx=ctx))
            if cdt is not None and torch.finfo(cdt).bits < 32:
                # Loss math in fp32 when the compute dtype is narrower.
                out = NDArray(out._data.to(torch.float32), ctx=ctx)
            loss = self.loss_fn(out, NDArray(y, ctx=ctx))
            mean = loss._data.mean() * share
        names = list(self._param_vals)
        grads = torch.autograd.grad(
            mean, [self._param_vals[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None
                     else torch.zeros_like(self._param_vals[n]))
                 for n, g in zip(names, grads)}
        new_aux = {}
        for p, v in ov.writes.items():
            nv = v._data if isinstance(v, NDArray) else v
            new_aux[p.name] = nv.detach()
        return mean.detach(), grads, new_aux

    def _dp_loss_and_grads(self, x, y):
        """The dp step over ranks: global-batch loss, gradients summed
        over the dp group, global BatchNorm statistics."""
        group = self._dp_group
        ndp = _coll.group_size(group)
        # This rank's share of the global batch; the shards are equal
        # (dist.local_slice), so local_n / global_n = 1 / ndp, and 1
        # exactly at one rank.
        share = x.shape[0] / (x.shape[0] * ndp)
        loss, grads, new_aux = self._loss_and_grads(
            x, y, reducer=(share, lambda t: _coll.all_reduce(t, group)),
            share=share)
        # A parameter split over dp had its gradient summed in the
        # gather's backward.
        names = [n for n in grads
                 if "dp" not in self._shardings[n].axes]
        summed = _coll.all_reduce_flat(
            [loss.reshape(1)] + [grads[n] for n in names], group)
        grads.update(zip(names, summed[1:]))
        return self._sync_replicas(summed[0].reshape(()), grads, new_aux)

    def _sync_replicas(self, loss, grads, new_aux):
        """The loss, gradients and aux values of the rank at index 0 of
        every non-batch axis a tensor is not split over, broadcast over
        that axis: the replicas of a parameter, its optimizer state and
        the aux state are then one array by construction, whatever bits
        each rank's forward and backward gave (cuDNN's default
        algorithms are not deterministic). A no-op on a dp-only mesh."""
        mesh = self.mesh
        aux_names = list(new_aux)
        for ax in mesh.axis_names:
            if ax in _coll.BATCH_AXES or mesh.shape[ax] == 1:
                continue
            names = [n for n in grads if ax not in self._shardings[n].axes]
            got = _coll.broadcast_flat(
                [loss.reshape(1)] + [grads[n] for n in names] +
                [new_aux[n] for n in aux_names],
                mesh.axis_ranks(ax)[0], mesh.group(ax))
            loss = got[0].reshape(())
            grads.update(zip(names, got[1:1 + len(names)]))
            new_aux.update(zip(aux_names, got[1 + len(names):]))
        return loss, grads, new_aux

    def _deterministic_loss_and_grads(self, x, y):
        """Per-shard loss, gradients and BatchNorm statistics, gathered
        and summed in ascending rank order, divided by the dp size (the
        JAX package's ``ordered_mean``)."""
        loss, grads, new_aux = self._loss_and_grads(x, y)
        group = self._dp_group
        if group is None:
            return loss, grads, new_aux
        names = list(grads)
        aux_names = list(new_aux)
        parts = [loss.reshape(1)] + [grads[n] for n in names] + \
            [new_aux[n] for n in aux_names]
        out = []
        for dtype in dict.fromkeys(p.dtype for p in parts):
            idx = [i for i, p in enumerate(parts) if p.dtype == dtype]
            flat = torch.cat([parts[i].reshape(-1) for i in idx])
            gathered = _coll.gather_slots(flat, group)
            acc = gathered[0]
            for i in range(1, gathered.shape[0]):
                acc = acc + gathered[i]
            acc = acc / gathered.shape[0]
            off = 0
            for i in idx:
                n = parts[i].numel()
                out.append((i, acc[off:off + n].view(parts[i].shape)))
                off += n
        res = [t for _, t in sorted(out, key=lambda e: e[0])]
        k = len(names)
        return (res[0].reshape(()), dict(zip(names, res[1:1 + k])),
                dict(zip(aux_names, res[1 + k:])))

    def _apply_update(self, grads, new_aux, t):
        """Update the masters, optimizer state and aux state in place,
        and bump the step counter."""
        # In place from here to the counter's bump: a snapshot taken in
        # between would mix two steps (checkpoint.guard).
        with torch.no_grad(), _guard.updating():
            for name, p in self._param_vals.items():
                g = grads[name].to(torch.float32)
                new_p, new_s = self._opt_update(p, g, self._opt_state[name],
                                                self.lr, t, self._split(name))
                p.copy_(new_p)
                for s, ns in zip(self._opt_state[name], new_s):
                    s.copy_(ns)
            for name, v in new_aux.items():
                # Running stats keep their stored (fp32) dtype.
                self._aux_vals[name].copy_(v)
            self.num_update = t

    def __call__(self, x, y):
        """Run one training step; returns the mean loss as a 0-d fp32
        tensor on the mesh's device (reading it waits for the step).

        Over a mesh of ranks, `x`/`y` are this rank's local slice of the
        global batch, its block along ``dp`` (``mesh.local_slice`` gives
        the rows; ``dist.local_slice`` on a dp-only mesh), and the loss
        is the global batch's, the same on every rank."""
        _profiler.step_boundary()
        t_start = time.perf_counter()
        if self._hp_component is None:
            self._hp_component = _hp.unique_component("train_step")
        # Heartbeat lane for the hang watchdog: work between begin/end
        # past its deadline fires a `step_hang` anomaly.
        _watchdog.begin("step")
        try:
            x, y = _as_tensor(x), _as_tensor(y)
            if not self._materialized:
                self._materialize(x[:1])
            with _trace.span("train_step::data_put"):
                x = x.to(self._device, non_blocking=True)
                y = y.to(self._device, non_blocking=True)
            t = self.num_update + 1
            with _trace.span("train_step::dispatch", step=t):
                if self.deterministic_reduction:
                    loss, grads, new_aux = \
                        self._deterministic_loss_and_grads(x, y)
                elif self._dp_group is not None:
                    loss, grads, new_aux = self._dp_loss_and_grads(x, y)
                else:
                    loss, grads, new_aux = self._loss_and_grads(x, y)
                self._apply_update(grads, new_aux, t)
            if _attr.device_spans_enabled():
                # Step attribution's device bracket: how long the card
                # still works after the dispatch returned. Gated: the
                # wait makes every step host-synchronous.
                with _trace.span("train_step::device", step=t):
                    if self._device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self._device))
                        done.synchronize()
            t_end = time.perf_counter()
            _trace.complete("train_step::step", t_start, t_end, step=t)
            _step_seconds.observe(t_end - t_start)
            _steps_total.inc()
            if self._first_step_pending:
                # The first step: where the JAX package traces and
                # compiles the whole step.
                self._first_step_pending = False
                _ms.observe_compile("train_step", t_end - t_start)
            if not self._hp_ready:
                self._hp_ready = True
                _hp.set_ready(self._hp_component)
            return loss
        finally:
            _watchdog.end("step")

    def set_learning_rate(self, lr):
        self.lr = float(lr)

    def _split(self, name):
        """The sharding of parameter `name` where it is split across
        ranks, else None."""
        s = self._shardings.get(name)
        return s if s is not None and s.axes and self.mesh.over_ranks \
            else None

    def _full_state(self):
        """(params, opt_state, aux) as full arrays on the step's device:
        the split ones gathered (every rank of the mesh calls this), the
        rest the live tensors."""
        names = list(self._param_vals)
        k = self._opt_n_states
        blocks = [self._param_vals[n] for n in names] + \
            [self._opt_state[n][i] for n in names for i in range(k)]
        shardings = [self._shardings[n] for n in names] + \
            [self._shardings[n] for n in names for _ in range(k)]
        with torch.no_grad():
            full = [t.detach() for t in _coll.gather(blocks, shardings)]
        params = dict(zip(names, full[:len(names)]))
        rest = iter(full[len(names):])
        opt = {n: tuple(next(rest) for _ in range(k)) for n in names}
        return params, opt, dict(self._aux_vals)

    def state_to_host(self):
        """(params, opt_state, aux) as host numpy dicts of the full
        arrays (over a mesh of ranks, every rank calls it): copies, which
        later steps do not change."""
        def host(t):
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            return t.detach().to("cpu", copy=True).numpy()

        params, opt, aux = self._full_state()
        return ({n: host(v) for n, v in params.items()},
                {n: tuple(host(s) for s in st) for n, st in opt.items()},
                {n: host(v) for n, v in aux.items()})

    # -- checkpoint state (mxnet_tpu_torch.checkpoint) ------------------------

    def _rng_entry(self):
        """The port's RNG position: root seed, host counter and every
        device generator's state (the step's own device always among
        them), each as bytes."""
        _random.generator(self.mesh.context)
        seed, counter, gens = _random.get_state()
        if self.mesh.over_ranks and len(self.mesh.ranks) > 1:
            gens = {}
        return {"seed": int(seed), "counter": int(counter),
                "generators": {d: bytes(g.numpy().tobytes())
                               for d, g in gens.items()}}

    def state_dict(self, sharded=None):
        """Checkpointable state as a nested dict: params, optimizer
        state, aux (BN stats), step counter and RNG position, the keys
        of the JAX package's ``TrainStep.state_dict``.

        The arrays are copies on the step's device (the manager copies
        them to the host at ``save``), so the dict is a snapshot later
        steps do not change. Inside the update loop this raises
        ``checkpoint.StepInProgressError`` (``checkpoint/guard.py``).
        By default the arrays are full: over a mesh of ranks the split
        ones are gathered, so every rank calls this. ``sharded=True``
        gives each array as a ``checkpoint.Shard`` of its global shape
        holding this rank's block, where the rank holds the block's
        first replica (index 0 on every mesh axis the array is not split
        over, the JAX package's ``replica_id == 0``), and no chunk
        elsewhere: a replicated array comes whole from rank 0 only. The
        manager writes each rank's chunks and stitches them; restore
        takes full arrays, on any mesh. Over a mesh of several ranks
        the RNG entry holds the root seed and host counter only: each
        rank's device generators draw its own stream
        (``random.set_rank``). Restore with :meth:`load_state_dict`."""
        if not self._materialized:
            raise RuntimeError(
                "run one step before state_dict so there is state to "
                "snapshot")
        _guard.check("TrainStep")
        if sharded:
            from ..checkpoint.manager import Shard

            whole = NamedSharding(self.mesh, P())

            def conv(t, name=None):
                s = self._shardings.get(name, whole)
                shape = self._shapes.get(name, tuple(t.shape))
                chunks = [(s.bounds(shape), t)] if s.holds_primary() \
                    else []
                return Shard(shape, t.dtype, chunks)

            params, opt, aux = (self._param_vals, self._opt_state,
                                self._aux_vals)
        else:
            def conv(t, name=None):
                return t.detach().clone()

            params, opt, aux = self._full_state()
        with torch.no_grad():
            return {
                "params": {n: conv(v, n) for n, v in params.items()},
                "opt": {n: {str(i): conv(sv, n) for i, sv in enumerate(st)}
                        for n, st in opt.items()},
                "aux": {n: conv(v) for n, v in aux.items()},
                "num_update": int(self.num_update),
                "rng": self._rng_entry(),
            }

    def _install(self, params, opt, aux, num_update, rng):
        """Copy a restored state (full arrays) into the step's tensors,
        in their live dtypes: this rank's block of a split one.
        Everything is converted and shape-checked before the first
        write, so a mismatched state raises cleanly instead of leaving a
        half-loaded step."""
        from ..checkpoint.state import to_tensor

        dev = self._device

        def conv(value, like, name, split=None):
            t = to_tensor(value, dev, like.dtype)
            want = self._shapes[name] if split is not None \
                else tuple(like.shape)
            if tuple(t.shape) != tuple(want):
                raise ValueError("%s: checkpoint shape %s, step holds %s"
                                 % (name, tuple(t.shape), tuple(want)))
            if split is not None:
                t = t[tuple(slice(a, b) for a, b in split.bounds(t.shape))]
            return t

        writes = []
        for n, v in self._param_vals.items():
            split = self._split(n)
            writes.append((v, conv(params[n], v, n, split)))
            for i, sv in enumerate(self._opt_state[n]):
                writes.append((sv, conv(opt(n, i), sv, n, split)))
        for n, v in self._aux_vals.items():
            writes.append((v, conv(aux[n], v, n)))
        gens = None
        if rng is not None and rng.get("generators") is not None:
            gens = {d: torch.frombuffer(bytearray(b), dtype=torch.uint8)
                    for d, b in rng["generators"].items()
                    if torch.device(d).type == "cpu"
                    or torch.cuda.is_available()}
        elif rng is not None:
            logging.warning(
                "TrainStep: the checkpoint's RNG entry holds no torch "
                "generator states (a state of the JAX package); it is "
                "ignored and the port's RNG position is kept")
        with torch.no_grad(), _guard.updating():
            for live, new in writes:
                live.copy_(new)
            self.num_update = int(num_update)
        if gens is not None:
            _random.set_state(int(rng["seed"]), int(rng["counter"]), gens)

    def _materialize_for_restore(self):
        if self._materialized:
            return
        if any(p._data is None and p._deferred_init is not None
               for p in self.net.collect_params().values()):
            raise RuntimeError(
                "net has deferred-init parameters; run one step (or a "
                "forward) before restoring so shapes exist")
        self._materialize(None)

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot (of either package).
        Resume is bit-exact: params, optimizer state, step counter and
        the RNG position all continue as the uninterrupted run would.
        Empty sections (stateless optimizer, no BN aux) drop out of a
        flattened checkpoint: absent means empty here."""
        self._materialize_for_restore()
        opt = state.get("opt", {})
        self._install(state.get("params", {}),
                      lambda n, i: opt.get(n, {})[str(i)],
                      state.get("aux", {}), state["num_update"],
                      state.get("rng"))

    def save_checkpoint(self, path):
        """Write params + optimizer state + aux + step counter in the
        binary ``.params`` wire format (reference
        save_checkpoint/save_optimizer_states, model.py:383-413), with
        the JAX package's keys: ``step:num_update``, ``step:rng`` (root
        seed and host counter), ``arg:<name>``, ``opt:<i>:<name>`` and
        ``aux:<name>``; the device generators' states follow as
        ``step:rng_state:<device>`` (uint8), which the JAX package does
        not read. Over a mesh of ranks every rank gathers (the arrays
        are full) and rank 0 writes, as in the JAX package. Returns the
        filename."""
        from .. import ndarray as nd
        from ..context import cpu

        if not self._materialized:
            raise RuntimeError(
                "run one step before save_checkpoint so there is state "
                "to save")
        state = self.state_dict()
        host = cpu()
        rng = state["rng"]
        flat = {"step:num_update": np.asarray(state["num_update"],
                                              np.int64),
                "step:rng": np.asarray([rng["seed"], rng["counter"]],
                                       np.int64)}
        for d, b in sorted(rng["generators"].items()):
            flat["step:rng_state:" + d] = np.frombuffer(b, np.uint8)
        for n, v in state["params"].items():
            flat["arg:" + n] = v
        for n, st in state["opt"].items():
            for i in range(len(st)):
                flat["opt:%d:%s" % (i, n)] = st[str(i)]
        for n, v in state["aux"].items():
            flat["aux:" + n] = v
        if not self.mesh.over_ranks or _dist.rank() == 0:
            nd.save(path, {k: NDArray(v.cpu(), ctx=host)
                           if isinstance(v, torch.Tensor)
                           else nd.array(v, ctx=host, dtype=v.dtype)
                           for k, v in flat.items()})
        if self.mesh.over_ranks:
            _dist.barrier()
        return path

    def load_checkpoint(self, path):
        """Restore a :meth:`save_checkpoint` file of either package."""
        from .. import ndarray as nd
        from ..context import cpu

        self._materialize_for_restore()
        blob = nd.load(path, ctx=cpu())

        def entry(key):
            return blob[key]._data

        rng = None
        if "step:rng" in blob:
            seed, counter = blob["step:rng"].asnumpy().ravel()
            prefix = "step:rng_state:"
            gens = {k[len(prefix):]: entry(k).numpy().tobytes()
                    for k in blob if k.startswith(prefix)}
            rng = {"seed": int(seed), "counter": int(counter),
                   "generators": gens or None}
        self._install({n: entry("arg:" + n) for n in self._param_vals},
                      lambda n, i: entry("opt:%d:%s" % (i, n)),
                      {n: entry("aux:" + n) for n in self._aux_vals},
                      int(blob["step:num_update"].asnumpy().ravel()[0]),
                      rng)

    def sync_to_net(self):
        """Copy the step's parameter and aux values back into the net's
        Parameters (full values: over a mesh of ranks, every rank calls
        it)."""
        names = list(self._param_vals)
        with torch.no_grad():
            full = _coll.gather([self._param_vals[n] for n in names],
                                [self._shardings[n] for n in names])
        params = {n: t.detach() for n, t in zip(names, full)}
        for p in self._train_params:
            p.set_data(NDArray(params[p.name].clone(),
                               ctx=self.mesh.context))
        for p in self._aux_params:
            p.set_data(NDArray(self._aux_vals[p.name].clone(),
                               ctx=self.mesh.context))
