"""Neural-network operators on the served path.

Counterpart of the subset of ``mxnet_tpu/ops/nn.py`` that ResNet, the
served functions and the language models use: FullyConnected,
Convolution, Pooling, BatchNorm, Activation, softmax, log_softmax, the
SoftmaxOutput loss head, Dropout and Embedding.
Convolution and the dense layer go to PyTorch's library calls, as the
JAX package leaves them to XLA.

Two semantics differ from what PyTorch's functional ops do by default,
and are written out here:

- Pooling: ``pooling_convention="full"`` pads extra on the right so
  that ceil division is honoured, and average pooling divides by the
  whole kernel (``count_include_pad=True``) or by the count of real
  elements; torch's ``ceil_mode`` divides differently at the edge. The
  padding is therefore applied explicitly (-inf for max, 0 for average)
  and the pooling runs unpadded.
- BatchNorm in train mode folds ``moving*momentum + batch*(1-momentum)``
  with the *biased* batch variance; ``F.batch_norm`` uses the opposite
  momentum convention and stores the unbiased variance, so train mode is
  written out. Eval mode, the same normalisation either way, uses
  ``F.batch_norm``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

_CHANNEL_FIRST = (None, "NCW", "NCHW", "NCDHW")


def _tuple(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


@register("Convolution", aliases=("convolution",))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 layout="NCHW", preferred_element_type=None):
    if layout not in _CHANNEL_FIRST:
        raise ValueError("Convolution supports channel-first layouts only "
                         "(got %r)" % (layout,))
    ndim = len(kernel) if kernel else weight.ndim - 2
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[ndim]
    out = conv(data, weight, None if no_bias else bias,
               stride=tuple(stride) or 1, padding=tuple(pad) or 0,
               dilation=tuple(dilate) or 1, groups=num_group)
    if preferred_element_type is not None:
        out = out.to(torch_dtype(preferred_element_type))
    return out


_POOL = {"max": (F.max_pool1d, F.max_pool2d, F.max_pool3d),
         "avg": (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)}


@register("Pooling", aliases=("pooling",))
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             cudnn_off=False):
    ndim = data.ndim - 2
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError("unknown pool_type %s" % pool_type)
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=axes, keepdim=True)
        return torch.mean(data, dim=axes, keepdim=True)
    kernel = _tuple(kernel, ndim)
    stride = _tuple(stride, ndim) if stride else (1,) * ndim
    pad = _tuple(pad, ndim) if pad else (0,) * ndim
    extra = [0] * ndim
    if pooling_convention == "full":
        for i in range(ndim):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if rem else 0
    # F.pad lists (left, right) pairs from the last dimension backwards.
    pads = []
    for i in reversed(range(ndim)):
        pads += [pad[i], pad[i] + extra[i]]
    if pool_type == "max":
        x = F.pad(data, pads, value=-math.inf) if any(pads) else data
        return _POOL["max"][ndim - 1](x, kernel, stride)
    avg = _POOL["avg"][ndim - 1]
    x = F.pad(data, pads) if any(pads) else data
    mean = avg(x, kernel, stride)
    if pool_type == "sum":
        return mean * math.prod(kernel)
    if count_include_pad or not any(pads):
        return mean
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return mean / avg(F.pad(ones, pads), kernel, stride)


class _BatchVariance(torch.autograd.Function):
    """torch.var(data) over `red` (biased), differentiated as
    mean(centered * centered) with respect to `centered`, the caller's
    data minus its mean: the gradient autodiff of jnp.var gives in the
    JAX package.

    torch.var's own backward, 2/n (x - mean(x)), rounds x - mean(x) a
    second time, so the gradient of anything that shifts a channel
    before BatchNorm (a bias there: zero in exact arithmetic) carries
    noise in proportion to |x|. Through `centered`, the mean's share
    returns through the caller's mean and cancels against the same
    rounded values, leaving noise in proportion to |x - mean(x)|. The
    value stays torch.var's, so the forward is unchanged."""

    @staticmethod
    def forward(ctx, data, centered, red):
        ctx.save_for_backward(centered)
        ctx.red = red
        return torch.var(data, dim=red, unbiased=False)

    @staticmethod
    def backward(ctx, grad):
        (centered,) = ctx.saved_tensors
        n = centered.numel() // grad.numel()
        for d in ctx.red:
            grad = grad.unsqueeze(d)
        return None, grad * centered * (2.0 / n), None


@register("BatchNorm", aliases=("batch_norm",), train_aware=True)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                axis=1, training=False):
    """Returns (out, new_moving_mean, new_moving_var): train mode
    normalises with batch stats and folds them into the moving stats;
    eval mode uses the moving stats. The caller commits the new stats."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    axis = axis % data.ndim
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    if training and not use_global_stats:
        red = tuple(i for i in range(data.ndim) if i != axis)
        mean = torch.mean(data, dim=red)
        centered = data - mean.reshape(shape)
        var = _BatchVariance.apply(data, centered, red)
        # The moving stats are aux state: never part of a graph.
        new_mm = moving_mean.detach() * momentum \
            + mean.detach() * (1 - momentum)
        new_mv = moving_var.detach() * momentum \
            + var.detach() * (1 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
        if axis == 1:
            out = F.batch_norm(data, mean, var, g, beta, training=False,
                               eps=eps)
            return out, new_mm, new_mv
        centered = data - mean.reshape(shape)
    inv = torch.rsqrt(var.reshape(shape) + eps)
    out = centered * inv * g.reshape(shape) + beta.reshape(shape)
    return out, new_mm, new_mv


_ACT = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "relu6": lambda x: torch.clamp(x, 0, 6),
}


@register("Activation", aliases=("activation",))
def _activation(data, act_type="relu"):
    try:
        fn = _ACT[act_type]
    except KeyError:
        raise ValueError("unknown act_type %s" % act_type) from None
    return fn(data)


@register("softmax")
def _softmax(data, axis=-1, temperature=None, length=None):
    x = data / temperature if temperature else data
    if length is not None:
        n = data.shape[axis]
        mask = torch.arange(n, device=data.device) < length[..., None]
        x = torch.where(mask, x, torch.tensor(-math.inf, dtype=x.dtype,
                                              device=x.device))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the loss's own gradient, as in
    ``mxnet_tpu/ops/nn.py:_softmax_output_impl`` (reference
    softmax_output-inl.h): (softmax - onehot(label)), masked where the
    label is ignored, normalized, scaled by ``grad_scale``. The incoming
    head gradient is ignored; the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization, smooth_alpha):
        axis = 1 if multi_output else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.opts = (axis, grad_scale, ignore_label, use_ignore,
                    normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization, \
            smooth_alpha = ctx.opts
        axis = axis % out.ndim
        depth = out.shape[axis]
        lab = label.to(torch.int32)
        classes = torch.arange(depth, device=out.device).view(
            [depth if i == axis else 1 for i in range(out.ndim)])
        # Out-of-range labels (an ignored -1) give an all-zero row, as
        # jax.nn.one_hot does.
        onehot = (lab.unsqueeze(axis) == classes).to(out.dtype)
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) \
                + smooth_alpha / (depth - 1) * (1 - onehot)
        grad = out - onehot
        keep = None
        if use_ignore:
            keep = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(axis)
        if normalization == "valid":
            count = keep.sum() if keep is not None else torch.tensor(
                float(lab.numel()), dtype=out.dtype, device=out.device)
            grad = grad / torch.clamp(count, min=1.0)
        elif normalization == "batch":
            grad = grad / float(lab.shape[0])
        grad = grad * grad_scale
        label_grad = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return (grad, label_grad) + (None,) * 6


@register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(multi_output),
                                bool(use_ignore), str(normalization),
                                float(smooth_alpha))


@register("Dropout", aliases=("dropout",), train_aware=True, needs_rng=True)
def _dropout(data, p=0.5, mode="training", axes=(), training=False,
             generator=None):
    """Inverted dropout: in training (or ``mode="always"``) each element
    is kept with probability 1 - p and scaled by 1 / (1 - p); `axes`
    share one draw along the axes named. The draw comes from
    `generator`, the device's (mxnet_tpu/ops/nn.py:510)."""
    if not training and mode != "always":
        return data
    keep = 1.0 - float(p)
    shape = tuple(1 if i in tuple(axes) else n
                  for i, n in enumerate(data.shape))
    mask = torch.empty(shape, dtype=data.dtype, device=data.device)
    mask.bernoulli_(keep, generator=generator)
    return data * (mask / keep)


@register("Embedding", aliases=("embedding",))
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """Rows of `weight` at the indices `data` (any float or integer
    dtype), clipped into [0, input_dim) as the JAX op clips them: an
    index out of range reads the nearest row and never reaches the card
    as a device-side assert."""
    idx = torch.clamp(data.to(torch.int64), 0, weight.shape[0] - 1)
    return F.embedding(idx, weight)
