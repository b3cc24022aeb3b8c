"""Fused optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op.cc:43-651). The formulas are the JAX
package's, term for term and in the same order: the gradient is
rescaled, clipped to ``clip_gradient`` when that is positive, and gets
``wd * weight`` added (Ftrl, FTML, SignSGD and Signum place these steps
as their reference ops do); then

- ``sgd_update``: ``w - lr * g``;
- ``sgd_mom_update``: ``mom = momentum * mom - lr * g``, ``w + mom``;
- ``mp_sgd_update`` / ``mp_sgd_mom_update``: the same on the fp32
  master ``weight32``, the gradient widened to fp32 first, and the
  weight returned cast back to its own dtype;
- ``nag_mom_update``: ``mom = momentum * mom + g``,
  ``w - lr * (g + momentum * mom)``;
- ``adam``, ``rmsprop``, ``rmspropalex`` (centered RMSProp), ``ftrl``,
  ``ftml``, ``signsgd``, ``signum``, ``adagrad``, ``adadelta`` and
  ``multi_sum_sq`` as in the JAX package.

Each returns the new buffers (weight first, then the states, then the
master for the mp forms); the caller commits them, or an ``out=`` does.
None is differentiable.

Scalars. ``lr``, ``wd``, ``momentum`` and ``rescale_grad`` go through
:func:`_c`, which rounds a Python number to the dtype of the tensor it
multiplies, as the JAX package's ``_c`` casts it there, and passes a
tensor through untouched. The fused multi-tensor apply
(``fused_update.py``) hands ``lr`` and ``wd`` in as tensors of that
dtype (one value per element, or one for the whole chunk); each element
then meets the same value through the same op as in the per-parameter
loop, so the two paths agree bit for bit at every size. For the same
reason the bodies use only single-rounding ops — no ``alpha=``,
``addcmul``, ``addcdiv`` or ``lerp``, whose vectorized and scalar code
paths may contract a multiply-add differently.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .registry import register


@functools.lru_cache(maxsize=4096)
def _round_to(value, dtype):
    if dtype == torch.float32:
        return float(np.float32(value))
    if dtype == torch.float64:
        return float(value)
    return float(torch.tensor(value, dtype=dtype))


def _c(value, dtype):
    """A hyperparameter in `dtype`: a Python number rounded to it (the
    torch op then holds that value exactly, whatever its opmath type),
    a tensor as it is."""
    if isinstance(value, torch.Tensor):
        return value
    return _round_to(float(value), dtype)


def _rescale_clip(grad, rescale_grad, clip_gradient):
    # x * 1.0 == x bit for bit (NaN and -0.0 included): skip the launch.
    g = grad if (not isinstance(rescale_grad, torch.Tensor)
                 and rescale_grad == 1.0) else \
        grad * _c(rescale_grad, grad.dtype)
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return g + _c(wd, weight.dtype) * weight


@register("sgd_update", differentiable=False)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - _c(lr, weight.dtype) * g


@register("sgd_mom_update", differentiable=False)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = _c(momentum, mom.dtype) * mom - _c(lr, mom.dtype) * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", differentiable=False)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g32 = _apply_wd_rescale(weight32, grad.to(weight32.dtype), wd,
                            rescale_grad, clip_gradient)
    new_w32 = weight32 - _c(lr, weight32.dtype) * g32
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", differentiable=False)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g32 = _apply_wd_rescale(weight32, grad.to(weight32.dtype), wd,
                            rescale_grad, clip_gradient)
    new_mom = _c(momentum, mom.dtype) * mom - _c(lr, mom.dtype) * g32
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", differentiable=False)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = _c(momentum, mom.dtype) * mom + g
    return (weight - _c(lr, weight.dtype)
            * (g + _c(momentum, mom.dtype) * new_mom)), new_mom


@register("adam_update", differentiable=False)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * g * g
    upd = _c(lr, weight.dtype) * new_mean / (torch.sqrt(new_var) + epsilon)
    return weight - upd, new_mean, new_var


@register("rmsprop_update", differentiable=False)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * g * g
    new_w = weight - _c(lr, weight.dtype) * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", differentiable=False)
def _rmspropalex_update(weight, grad, n, g_buf, delta, lr=0.001, gamma1=0.9,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * g * g
    new_g = gamma1 * g_buf + (1 - gamma1) * g
    new_delta = gamma2 * delta - _c(lr, delta.dtype) * g / torch.sqrt(
        new_n - new_g * new_g + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftrl_update", differentiable=False)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1,
        torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("ftml_update", differentiable=False)
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    g = grad * _c(rescale_grad, grad.dtype) + wd * weight
    if clip_grad is not None and clip_grad > 0:
        g = g.clamp(-clip_grad, clip_grad)
    new_v = beta2 * v + (1 - beta2) * g * g
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    new_w = -new_z / d_t
    return new_w, d_t, new_v, new_z


@register("signsgd_update", differentiable=False)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - _c(lr, weight.dtype) * (
        torch.sign(g) + _c(wd, weight.dtype) * weight)


@register("signum_update", differentiable=False)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    lr = _c(lr, weight.dtype)
    if wd_lh:
        # 1 - lr * wd_lh as a tensor op in both paths (a runtime lr
        # computes it in the weight dtype; so must a Python lr).
        if not isinstance(lr, torch.Tensor):
            lr = torch.tensor(lr, dtype=weight.dtype, device=weight.device)
        new_w = (1 - lr * wd_lh) * weight
    else:
        new_w = weight
    return new_w + lr * torch.sign(new_mom), new_mom


@register("adagrad_update", differentiable=False,
          aliases=("_sparse_adagrad_update",))
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_hist = history + g * g
    return (weight - _c(lr, weight.dtype) * g
            / (torch.sqrt(new_hist) + epsilon)), new_hist


@register("adadelta_update", differentiable=False)
def _adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * g * g
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(new_acc_g + epsilon) \
        * g
    new_acc_delta = rho * acc_delta + (1 - rho) * delta * delta
    return weight - delta, new_acc_g, new_acc_delta


@register("multi_sum_sq", differentiable=False)
def _multi_sum_sq(*arrays, num_arrays=0):
    return torch.stack([torch.sum(a.to(torch.float32) ** 2) for a in arrays])
