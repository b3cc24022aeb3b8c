"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``: dense, convolution and
deconvolution, pooling, the normalizations, activations, the softmax
family, the loss heads (SoftmaxOutput, the regression outputs,
MakeLoss), Dropout, Embedding and the resampling ops (UpSampling,
GridGenerator, BilinearSampler, SpatialTransformer). Convolution,
deconvolution, the dense layer, bilinear resizing and sampling go to
PyTorch's library calls, as the JAX package leaves them to XLA.
The normalizations compute the variance as the mean of the squared
centered values, the expression whose autodiff ``jnp.var`` gives.

The loss heads are ``torch.autograd.Function``s whose backward is the
loss's own gradient and ignores the head gradient (reference
softmax_output-inl.h, regression_output-inl.h, make_loss-inl.h).

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


# -- the rest of mxnet_tpu/ops/nn.py ------------------------------------------

@register("Deconvolution", aliases=("deconvolution",))
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), num_filter=0, num_group=1, no_bias=False,
                   target_shape=(), layout=None):
    """Transposed convolution; `weight` is (C_in, C_out / group, *k) as
    in the reference, `adj` pads the output's far side."""
    if layout not in _CHANNEL_FIRST:
        raise ValueError("Deconvolution supports channel-first layouts "
                         "only (got %r)" % (layout,))
    ndim = len(kernel) if kernel else weight.ndim - 2
    conv = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
            3: F.conv_transpose3d}[ndim]
    return conv(data, weight, None if no_bias else bias,
                stride=tuple(stride) or 1, padding=tuple(pad) or 0,
                output_padding=tuple(adj) or 0, groups=num_group,
                dilation=tuple(dilate) or 1)


def _moments(data, axes):
    mean = torch.mean(data, dim=axes, keepdim=True)
    centered = data - mean
    return mean, centered, torch.mean(centered * centered, dim=axes,
                                      keepdim=True)


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalized over `axis`; with `output_mean_var` also the mean and
    the variance (the JAX package's second output is the variance)."""
    ax = axis % data.ndim
    mean, centered, var = _moments(data, (ax,))
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    out = centered * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3):
    _, centered, var = _moments(data, tuple(range(2, data.ndim)))
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return centered * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("L2Normalization", aliases=("l2_normalization",))
def _l2_normalization(data, eps=1e-10, mode="instance"):
    axes = {"instance": tuple(range(1, data.ndim)), "channel": (1,),
            "spatial": tuple(range(2, data.ndim))}.get(mode)
    if axes is None:
        raise ValueError(mode)
    return data / torch.sqrt(torch.sum(data * data, dim=axes, keepdim=True)
                             + eps)


@register("LRN", aliases=("lrn",))
def _lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Across-channel normalization: each channel over the `nsize`
    channels centred on it, zero beyond the edges."""
    half = nsize // 2
    sq = F.pad(data * data, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    ssum = sum(sq[:, i:i + c] for i in range(nsize))
    return data / ((knorm + alpha / nsize * ssum) ** beta)


@register("LeakyReLU", aliases=("leaky_relu",))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """leaky, elu, prelu (learned `gamma`, per channel), selu, gelu (the
    tanh form, jax.nn.gelu's default) and rrelu (the mean slope of its
    range, as the JAX package draws none)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, mid * data)
    raise ValueError("unknown act_type %s" % act_type)


@register("softmin")
def _softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation", aliases=("softmax_activation",))
def _softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64).unsqueeze(-1)
    return -torch.sum(torch.take_along_dim(logp, lab, dim=-1))


class _RegressionOutput(torch.autograd.Function):
    """identity (linear, mae) or sigmoid (logistic) forward; backward
    ``(out - label)`` (linear, logistic) or ``sign(out - label)`` (mae)
    times `grad_scale`, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        label_grad = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad * ctx.grad_scale, label_grad, None, None


def _register_regression(name, alias, kind):
    register(name, aliases=(alias,))(
        lambda data, label, grad_scale=1.0: _RegressionOutput.apply(
            data, label, kind, float(grad_scale)))


_register_regression("LinearRegressionOutput", "linear_regression_output",
                     "linear")
_register_regression("LogisticRegressionOutput",
                     "logistic_regression_output", "logistic")
_register_regression("MAERegressionOutput", "mae_regression_output", "mae")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward `grad_scale` per element whatever the
    head gradient, divided by the batch size (``"batch"``) or by the
    count of outputs above `valid_thresh`, at least 1 (``"valid"``), as
    the reference's make_loss-inl.h does. With the defaults that is the
    gradient of a loss summed over its elements."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.opts = (grad_scale, valid_thresh, normalization)
        ctx.save_for_backward(data)
        return data.clone()

    @staticmethod
    def backward(ctx, _head):
        (data,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.opts
        grad = torch.full_like(data, grad_scale)
        if normalization == "batch":
            grad = grad / data.shape[0]
        elif normalization == "valid":
            count = (data > valid_thresh).sum().to(data.dtype)
            grad = grad / torch.clamp(count, min=1.0)
        return grad, None, None, None


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return _MakeLoss.apply(data, float(grad_scale), float(valid_thresh),
                           str(normalization))


@register("UpSampling", aliases=("upsampling",))
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat"):
    """The first input scaled by `scale`: nearest repeats pixels,
    bilinear interpolates at half-pixel centres (jax.image.resize's
    upsampling)."""
    data = args[0]
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("GridGenerator", aliases=("grid_generator",))
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """An affine transform's (N, 2, H, W) sampling grid over [-1, 1]^2;
    any other transform_type returns `data`, as in the JAX package."""
    if transform_type != "affine":
        return data
    h, w = target_shape
    ys = torch.linspace(-1, 1, h, dtype=data.dtype, device=data.device)
    xs = torch.linspace(-1, 1, w, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])
    grid = torch.matmul(data.reshape(-1, 2, 3), base)
    return grid.reshape(-1, 2, h, w)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def _bilinear_sampler(data, grid, cudnn_off=False):
    """`data` sampled at `grid` ((N, 2, H, W): x then y in [-1, 1], the
    corners at the corner pixels' centres), zero outside."""
    return F.grid_sample(data, grid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=tuple(target_shape))
    return _bilinear_sampler(data, grid)
