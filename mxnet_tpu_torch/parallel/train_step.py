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

Not ported in this slice (ROADMAP Queue 1): the optimizer families other
than ``sgd`` and ``nag`` (item 3), meshes over more than one device
(item 7), ``state_dict``/checkpointing (item 5), the telemetry hooks
(spans, watchdog lane, health-plane readiness, memstats; item 9), the
compile cache (item 10) and ``deterministic_reduction``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..base import torch_dtype
from ..gluon.parameter import override
from ..ndarray.ndarray import NDArray
from .mesh import make_mesh, data_sharding

__all__ = ["TrainStep"]

# Families the JAX TrainStep supports beyond sgd/nag.
_QUEUED_FAMILIES = ("signum", "signsgd", "adam", "rmsprop", "adagrad",
                    "adadelta", "ftrl", "ftml", "nadam", "dcasgd", "sgld",
                    "lbsgd")


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
    optimizer : ``"sgd"`` (with or without momentum) or ``"nag"``.
    optimizer_params : dict — learning_rate, momentum, wd, rescale_grad,
        clip_gradient. The learning rate is a runtime value
        (:meth:`set_learning_rate`).
    mesh : :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` of one device
        (default: ``make_mesh()``, every CUDA device, so one card).
    dtype : compute dtype for mixed precision (``"bfloat16"``); masters
        and optimizer state stay fp32.
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, dtype=None):
        self.net = net
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else make_mesh()
        opt_params = dict(optimizer_params or {})
        self.lr = float(opt_params.pop("learning_rate", 0.01))
        self.optimizer = optimizer
        self.momentum = float(opt_params.pop("momentum", 0.0))
        self.wd = float(opt_params.pop("wd", 0.0))
        # Accepted for every family, as in the reference; sgd/nag read
        # none of them.
        for knob in ("beta1", "beta2", "epsilon"):
            opt_params.pop(knob, None)
        self.rescale_grad = float(opt_params.pop("rescale_grad", 1.0))
        clip = opt_params.pop("clip_gradient", None)
        self.clip_gradient = None if clip is None else float(clip)
        self._opt_n_states, self._opt_update = self._make_opt_rule(
            opt_params)
        self.num_update = 0
        self._dtype = None if dtype is None else torch_dtype(dtype)
        self._device = self.mesh.device
        self._data_sharding = data_sharding(self.mesh)
        self._materialized = False

    def _make_opt_rule(self, extra):
        """(n_states, update_fn(param, grad, states, lr, t) -> (new_param,
        new_states)) over the bodies of ops/optimizer_ops.py."""
        from ..ops import optimizer_ops as oo

        name = self.optimizer.lower()
        mom, wd, rs = self.momentum, self.wd, self.rescale_grad
        clip = -1.0 if self.clip_gradient is None else self.clip_gradient
        if name in _QUEUED_FAMILIES:
            raise NotImplementedError(
                "TrainStep(%r) is not ported yet: the port's TrainStep "
                "runs sgd and nag; the other optimizer families come with "
                "ROADMAP Queue 1 item 3" % name)
        if name not in ("sgd", "nag"):
            raise ValueError("TrainStep supports sgd/nag (got %r)"
                             % self.optimizer)
        if extra:
            raise ValueError("TrainStep(%s) got unsupported optimizer_params "
                             "%s" % (name, sorted(extra)))
        if mom > 0:
            body = oo._sgd_mom_update if name == "sgd" else oo._nag_mom_update

            def update(p, g, s, lr, t):
                w, m = body(p, g, s[0], lr=lr, momentum=mom, wd=wd,
                            rescale_grad=rs, clip_gradient=clip)
                return w, (m,)

            return 1, update
        return 0, lambda p, g, s, lr, t: (
            oo._sgd_update(p, g, lr=lr, wd=wd, rescale_grad=rs,
                           clip_gradient=clip), ())

    def _materialize(self, x_example):
        """Collect the parameters (inferring deferred shapes with one
        forward if needed) and copy them onto the mesh's device."""
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
        # Masters keep the parameter's own (fp32) dtype; they are leaves
        # of the step's graph, updated in place.
        self._param_vals = {
            p.name: p.data()._data.detach().to(dev).clone()
            .requires_grad_(True) for p in self._train_params}
        self._aux_vals = {p.name: p.data()._data.detach().to(dev).clone()
                          for p in self._aux_params}
        self._opt_state = {
            n: tuple(torch.zeros_like(v, dtype=torch.float32,
                                      requires_grad=False)
                     for _ in range(self._opt_n_states))
            for n, v in self._param_vals.items()}
        self._materialized = True

    def _loss_and_grads(self, x, y):
        """(mean loss, {name: fp32 gradient}, {aux name: new value})."""
        cdt = self._dtype
        ctx = self.mesh.context

        def cast(a):
            return a.to(cdt) if cdt is not None and a.is_floating_point() \
                else a

        mapping = {p: NDArray(cast(self._param_vals[p.name]), ctx=ctx)
                   for p in self._train_params}
        # Aux (BatchNorm running stats) stays fp32: it sits only on the
        # moving-average path, so the moments accumulate in fp32.
        mapping.update({p: NDArray(self._aux_vals[p.name], ctx=ctx)
                        for p in self._aux_params})
        ov = override(mapping)
        with autograd._differentiate(train_mode=True), ov:
            out = self.net(NDArray(cast(x), ctx=ctx))
            if cdt is not None and torch.finfo(cdt).bits < 32:
                # Loss math in fp32 when the compute dtype is narrower.
                out = NDArray(out._data.to(torch.float32), ctx=ctx)
            loss = self.loss_fn(out, NDArray(y, ctx=ctx))
            mean = loss._data.mean()
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

    def __call__(self, x, y):
        """Run one training step; returns the mean loss as a 0-d fp32
        tensor on the mesh's device (reading it waits for the step)."""
        x, y = _as_tensor(x), _as_tensor(y)
        if not self._materialized:
            self._materialize(x[:1])
        x = x.to(self._device, non_blocking=True)
        y = y.to(self._device, non_blocking=True)
        t = self.num_update + 1
        loss, grads, new_aux = self._loss_and_grads(x, y)
        with torch.no_grad():
            for name, p in self._param_vals.items():
                g = grads[name].to(torch.float32)
                new_p, new_s = self._opt_update(p, g, self._opt_state[name],
                                                self.lr, t)
                p.copy_(new_p)
                for s, ns in zip(self._opt_state[name], new_s):
                    s.copy_(ns)
            for name, v in new_aux.items():
                # Running stats keep their stored (fp32) dtype.
                self._aux_vals[name].copy_(v)
        self.num_update = t
        return loss

    def set_learning_rate(self, lr):
        self.lr = float(lr)

    def state_to_host(self):
        """(params, opt_state, aux) as host numpy dicts."""
        def host(t):
            return t.detach().to(torch.float32).cpu().numpy() \
                if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()

        return ({n: host(v) for n, v in self._param_vals.items()},
                {n: tuple(host(s) for s in st)
                 for n, st in self._opt_state.items()},
                {n: host(v) for n, v in self._aux_vals.items()})

    def sync_to_net(self):
        """Copy the step's parameter and aux values back into the net's
        Parameters."""
        for p in self._train_params:
            p.set_data(NDArray(self._param_vals[p.name].detach().clone(),
                               ctx=self.mesh.context))
        for p in self._aux_params:
            p.set_data(NDArray(self._aux_vals[p.name].clone(),
                               ctx=self.mesh.context))
