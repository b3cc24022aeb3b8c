"""Fused optimizer update operators: SGD, SGD with momentum, their
multi-precision forms and NAG.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py:32-80`` (reference:
src/operator/optimizer_op.cc). The formulas are the same, term for term:
the gradient is rescaled, clipped to ``clip_gradient`` when that is
positive, and gets ``wd * weight`` added; then

- ``sgd_update``: ``w - lr * g``;
- ``sgd_mom_update``: ``mom = momentum * mom - lr * g``, ``w + mom``;
- ``mp_sgd_update`` / ``mp_sgd_mom_update``: the same on the fp32
  master ``weight32``, the gradient widened to fp32 first, and the
  weight returned cast back to its own dtype;
- ``nag_mom_update``: ``mom = momentum * mom + g``,
  ``w - lr * (g + momentum * mom)``.

Each returns the new buffers (weight first, then the states, then the
master for the mp forms); the caller commits them, or an ``out=`` does.
None is differentiable.
"""
from __future__ import annotations

from .registry import register


def _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight


@register("sgd_update", differentiable=False)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update", differentiable=False)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", differentiable=False)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g32 = _apply_wd_rescale(weight32, grad.to(weight32.dtype), wd,
                            rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g32
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", differentiable=False)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g32 = _apply_wd_rescale(weight32, grad.to(weight32.dtype), wd,
                            rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g32
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", differentiable=False)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom
