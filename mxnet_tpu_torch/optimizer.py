"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference:
python/mxnet/optimizer.py — registry, SGD with momentum and
multi_precision fp32 master weights, Signum, SignSGD, NAG, Adam,
AdaGrad, AdaDelta, RMSProp, Ftrl, FTML, Nadam, DCASGD, SGLD, LBSGD,
Test; ``Updater`` with state (de)serialization).

Each update calls the update ops of ``ops/optimizer_ops.py`` through
``nd.*_update(..., out=...)``, which installs the new buffers in the
weight and state NDArrays (``NDArray._set_data``). Multi-precision keeps
an fp32 master copy when the weight is float16/bfloat16
(``MXNET_MP_LOWP_DTYPES``), the state being ``(inner, master)``.

Differences from the JAX package:

- row-sparse gradients raise (ROADMAP Queue 1 item 11: the port has no
  sparse NDArray);
- SGLD draws its noise from the port's per-device ``torch.Generator``
  (``random.generator``), so its numbers differ from the JAX package's
  for the same seed, as every draw of the two packages does;
- ``Updater.set_states`` unpickles through :class:`_PortUnpickler`: a
  payload the JAX package wrote with ``dump_optimizer=True`` names
  ``mxnet_tpu.optimizer.<Class>``, which is read as the port's class of
  that name; any other ``mxnet_tpu`` name is refused, so loading never
  imports the JAX package. States are placed on the context (and in the
  dtype) of the state they replace, or of ``state_ctx(index)``.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from . import ndarray as nd
from . import random as _random
from .base import dtype_name
from .context import current_context
from .ndarray.ndarray import NDArray
from .registry_util import Registry

__all__ = ["Optimizer", "SGD", "Signum", "SignSGD", "NAG", "Adam", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "FTML", "Nadam", "DCASGD", "SGLD",
           "LBSGD", "Updater", "get_updater", "create", "register"]

registry = Registry("optimizer")


def _sparse_unsupported(*args, **kwargs):
    raise NotImplementedError(
        "row-sparse optimizer updates need the sparse NDArray, which the "
        "port does not have yet (ROADMAP Queue 1 item 11)")


_rsp_rows = _sparse_sgd_update = _sparse_adam_update = _sparse_unsupported


def _mp_lowp_dtypes():
    """Dtype names eligible for fp32 master weights under
    ``multi_precision=True`` (``MXNET_MP_LOWP_DTYPES``)."""
    from . import env as _env

    raw = str(_env.get("MXNET_MP_LOWP_DTYPES"))
    return {s.strip() for s in raw.split(",") if s.strip()}


def register(cls):
    return registry.register(cls)


def create(name, **kwargs):
    return registry.create(name, **kwargs)


class Optimizer:
    """Base optimizer (reference: optimizer.py:Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.aggregate_num = 0

    create_optimizer = staticmethod(create)

    def create_state(self, index, weight):
        return None

    def _wants_master(self, weight):
        """Whether this weight keeps an fp32 master copy: low-precision
        dtype (``MXNET_MP_LOWP_DTYPES``, default float16 + bfloat16 —
        the reference only mastered fp16; bf16 is the TPU-native case)
        under ``multi_precision=True``."""
        if not self.multi_precision:
            return False
        return dtype_name(weight._data.dtype) in _mp_lowp_dtypes()

    def create_state_multi_precision(self, index, weight):
        if self._wants_master(weight):
            weight_master = weight.astype(np.float32)
            return (self.create_state(index, weight_master), weight_master)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._wants_master(weight):
            inner_state, weight_master = state
            grad32 = grad.astype(np.float32)
            self.update(index, weight_master, grad32, inner_state)
            weight._set_data(weight_master.astype(weight.dtype)._data)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0


@register
class SGD(Optimizer):
    """SGD with momentum + lazy sparse support (reference: optimizer.py:445)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            nd.sgd_update(weight, grad, lr=lr, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=self._clip(), out=weight)
        else:
            nd.sgd_mom_update(weight, grad, state, lr=lr, momentum=self.momentum,
                              wd=wd, rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(), out=(weight, state))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            nd.signsgd_update(weight, grad, lr=lr, wd=wd,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(), out=weight)
        else:
            nd.signum_update(weight, grad, state, lr=lr, momentum=self.momentum,
                             wd=wd, rescale_grad=self.rescale_grad,
                             clip_gradient=self._clip(), wd_lh=self.wd_lh,
                             out=(weight, state))


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            nd.sgd_update(weight, grad, lr=lr, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=self._clip(), out=weight)
        else:
            nd.nag_mom_update(weight, grad, state, lr=lr,
                              momentum=self.momentum, wd=wd,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(), out=(weight, state))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr_t = lr * (coef2 ** 0.5) / coef1
        mean, var = state
        nd.adam_update(weight, grad, mean, var, lr=lr_t, beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                       rescale_grad=self.rescale_grad,
                       clip_gradient=self._clip(), out=(weight, mean, var))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        nd.adagrad_update(weight, grad, state, lr=lr,
                          epsilon=self.float_stable_eps, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=self._clip(), out=(weight, state))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context),
                nd.zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        nd.adadelta_update(weight, grad, acc_g, acc_delta, rho=self.rho,
                           epsilon=self.epsilon, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self._clip(),
                           out=(weight, acc_g, acc_delta))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (nd.zeros(weight.shape, ctx=weight.context),
                    nd.zeros(weight.shape, ctx=weight.context),
                    nd.zeros(weight.shape, ctx=weight.context))
        return nd.zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        cw = self.clip_weights if self.clip_weights is not None else -1.0
        if self.centered:
            n, g, delta = state
            nd.rmspropalex_update(weight, grad, n, g, delta, lr=lr,
                                  gamma1=self.gamma1, gamma2=self.gamma2,
                                  epsilon=self.epsilon, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self._clip(), clip_weights=cw,
                                  out=(weight, n, g, delta))
        else:
            nd.rmsprop_update(weight, grad, state, lr=lr, gamma1=self.gamma1,
                              epsilon=self.epsilon, wd=wd,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(), clip_weights=cw,
                              out=(weight, state))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context),
                nd.zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        nd.ftrl_update(weight, grad, z, n, lr=lr, lamda1=self.lamda1,
                       beta=self.beta, wd=wd, rescale_grad=self.rescale_grad,
                       clip_gradient=self._clip(), out=(weight, z, n))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context),
                nd.zeros(weight.shape, ctx=weight.context),
                nd.zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        d, v, z = state
        nd.ftml_update(weight, grad, d, v, z, lr=lr, beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                       rescale_grad=self.rescale_grad, clip_grad=self._clip(),
                       t=t, out=(weight, d, v, z))


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context),
                nd.zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        mean, var = state
        mean._set_data((self.beta1 * mean + (1.0 - self.beta1) * grad)._data)
        var._set_data((self.beta2 * var + (1.0 - self.beta2) * grad * grad)._data)
        grad_prime = grad / (1.0 - self.m_schedule)
        m_t_prime = mean / (1.0 - m_schedule_next)
        v_t_prime = var / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        new_w = weight - lr * m_t_bar / (nd.sqrt(v_t_prime) + self.epsilon)
        weight._set_data(new_w._data)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer.py:DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (nd.zeros(weight.shape, ctx=weight.context), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        mom, previous_weight = state
        delta = -lr * (grad + wd * weight + self.lamda * grad * grad *
                       (weight - previous_weight))
        if mom is not None:
            mom._set_data((self.momentum * mom + delta)._data)
            delta = mom
        previous_weight._set_data(weight._data)
        weight._set_data((weight + delta)._data)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (reference: optimizer.py:SGLD)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        w = weight._data
        noise = NDArray(torch.randn(
            w.shape, generator=_random.generator(weight.context),
            device=w.device, dtype=w.dtype) * float(np.sqrt(lr)),
            ctx=weight.context)
        new_w = weight - lr / 2 * (grad + wd * weight) + noise
        weight._set_data(new_w._data)


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS-style scaling (reference: optimizer.py:LBSGD
    — here implemented as layer-wise adaptive rate scaling over SGD)."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)

    def update(self, index, weight, grad, state):
        # LARS trust-ratio scaling: lr_layer = lr * |w| / (|g| + wd*|w|)
        wnorm = float(weight.norm().asscalar())
        gnorm = float(grad.norm().asscalar()) * self.rescale_grad
        lr_save = self.lr
        if wnorm > 0 and gnorm > 0:
            self.lr = lr_save * min(wnorm / (gnorm + self.wd * wnorm + 1e-9), 10.0)
        try:
            super().update(index, weight, grad, state)
        finally:
            self.lr = lr_save


@register
class Test(Optimizer):
    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        weight._set_data((weight + grad * self.rescale_grad)._data)


class _PortUnpickler(pickle.Unpickler):
    """Reads an optimizer-state payload of either package without
    importing the JAX package: ``mxnet_tpu.optimizer.<Class>`` and
    ``mxnet_tpu.lr_scheduler.<Class>`` resolve to the port's classes of
    the same name, any other ``mxnet_tpu`` name is refused."""

    _MAPPED = {"mxnet_tpu.optimizer": "optimizer",
               "mxnet_tpu.lr_scheduler": "lr_scheduler"}

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "mxnet_tpu":
            target = self._MAPPED.get(module)
            if target is None:
                raise pickle.UnpicklingError(
                    "optimizer state names %s.%s, which has no counterpart "
                    "in mxnet_tpu_torch; refusing to import the JAX package"
                    % (module, name))
            import importlib

            mod = importlib.import_module("." + target, __package__)
            try:
                return getattr(mod, name)
            except AttributeError:
                raise pickle.UnpicklingError(
                    "%s.%s has no counterpart in mxnet_tpu_torch.%s"
                    % (module, name, target)) from None
        return super().find_class(module, name)


class Updater:
    """State-carrying update closure (reference: optimizer.py:Updater —
    used by KVStore servers; states pickle for checkpoints).

    ``state_ctx``: optional ``index -> Context`` that places a state
    loaded by :meth:`set_states` when no state of that index exists yet
    (the Trainer and the kvstore set it); without either, a loaded state
    goes to the current context."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.state_ctx = None

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """Pickle of ``{index: state}`` with every NDArray as numpy
        (bfloat16 widens to float32, as ``asnumpy`` does), and with the
        optimizer when `dump_optimizer`."""
        def to_np(s):
            if isinstance(s, NDArray):
                return s.asnumpy()
            if isinstance(s, (list, tuple)):
                return tuple(to_np(x) for x in s)
            return s

        states = {k: to_np(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states):
        data = _PortUnpickler(io.BytesIO(states)).load()
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            states, self.optimizer = data
        else:
            states = data

        def to_nd(s, like, ctx):
            if isinstance(s, np.ndarray):
                if isinstance(like, NDArray):
                    return nd.array(s, ctx=like.context,
                                    dtype=dtype_name(like._data.dtype))
                return nd.array(s, ctx=ctx)
            if isinstance(s, tuple):
                likes = like if isinstance(like, (list, tuple)) and \
                    len(like) == len(s) else (None,) * len(s)
                return tuple(to_nd(x, lk, ctx) for x, lk in zip(s, likes))
            return s

        new = {}
        for k, v in states.items():
            ctx = self.state_ctx(k) if self.state_ctx is not None else None
            new[k] = to_nd(v, self.states.get(k), ctx or current_context())
        self.states = new
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)
