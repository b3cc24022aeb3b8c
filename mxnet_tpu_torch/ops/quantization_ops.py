"""INT8 quantization operators.

Counterpart of ``mxnet_tpu/ops/quantization_ops.py`` (reference:
src/operator/quantization/: quantize.cc, quantize_v2.cc, dequantize.cc,
requantize.cc, quantized_conv.cc, quantized_fully_connected.cc): int8
inference with per-tensor symmetric scales and calibrated activation
ranges.

The four elementwise ops are plain tensor code and give the JAX
package's values bit for bit: a scale is computed in float32 with a
true division of two tensors (``scalar / tensor`` in PyTorch is a
reciprocal times the scalar, and a CUDA tensor divided by a Python
scalar multiplies by its reciprocal, so neither is used); a division by
a constant is a product with the constant's float32 reciprocal, which is
what XLA makes of the JAX package's division by a Python float
(:func:`_div_const`); rounding is ``torch.round``'s half to even, as
``jnp.round``'s.

The two contractions quantize the activation with its calibrated range
and multiply int8 by int8 into an exact int32 accumulator, as the JAX
package's ``preferred_element_type=int32`` does, then rescale to float32
in one epilogue. On a CUDA tensor the product is ``torch._int_mm``
(cuBLASLt's int8 GEMM; the JAX package leaves this contraction to XLA,
not to a Pallas kernel), with rows, depth and columns zero-padded onto
its shape rules, which adds nothing to the sums. On any other device the
integer values are contracted in float64, which is exact while every
partial sum stays below 2^53 (127 * 127 * depth). A CUDA tensor never
takes a floating-point contraction. ``_contrib_quantized_conv`` unfolds
its input (im2col, any number of spatial dims and groups) and goes
through the same contraction.

``INT8_GEMMS`` counts the int8 GEMMs run on a card.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["QUANT_MIN", "QUANT_MAX", "int8_matmul_nt", "INT8_GEMMS"]

QUANT_MIN, QUANT_MAX = -127.0, 127.0

# torch._int_mm calls made by the contractions on a CUDA card.
INT8_GEMMS = 0


def _f32(value, like):
    """`value` as a float32 scalar tensor on `like`'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _div_const(x, c):
    """x / c for a Python float `c`, as XLA lowers it: x times the
    float32 reciprocal of float32(c)."""
    return x * (_f32(1.0, x) / _f32(c, x))


def _amax(mn, mx):
    """max(|mn|, |mx|, 1e-12) in float32."""
    mn = torch.as_tensor(mn, dtype=torch.float32)
    mx = torch.as_tensor(mx, dtype=torch.float32, device=mn.device)
    return torch.clamp_min(torch.maximum(mn.abs(), mx.abs()), 1e-12)


def _to_int8(real, scale):
    q = torch.clamp(torch.round(real * scale), QUANT_MIN, QUANT_MAX)
    return q.to(torch.int8)


def _scale_of(min_range, max_range):
    """127 / max(|min|, |max|) in double, 127 for an empty range (the JAX
    package's Python float)."""
    amax = max(abs(float(min_range)), abs(float(max_range))) or 1.0
    return QUANT_MAX / amax


@register("_contrib_quantize", differentiable=False)
def _quantize(data, min_range, max_range, out_type="int8"):
    """float32 -> int8 with the given range (reference quantize.cc).
    Returns (quantized, min_range, max_range)."""
    amax = _amax(min_range, max_range)
    scale = _f32(QUANT_MAX, amax) / amax
    return _to_int8(data, scale), min_range, max_range


@register("_contrib_quantize_v2", differentiable=False)
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """float32 -> int8, the range from the calibration attrs or from the
    data itself (reference quantize_v2.cc)."""
    if min_calib_range is None or max_calib_range is None:
        mn, mx = torch.min(data), torch.max(data)
    else:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    amax = _amax(mn, mx)
    return _to_int8(data, _f32(QUANT_MAX, amax) / amax), mn, mx


@register("_contrib_dequantize", differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> float32 (reference dequantize.cc)."""
    amax = _amax(min_range, max_range)
    return data.to(torch.float32) * _div_const(amax, QUANT_MAX)


@register("_contrib_requantize", differentiable=False)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """int32 accumulator -> int8 with a narrower calibrated range
    (reference requantize.cc). Returns (q, new_min, new_max)."""
    amax = torch.maximum(torch.as_tensor(min_range).abs(),
                         torch.as_tensor(max_range).abs())
    real = data.to(torch.float32) * _div_const(amax,
                                               QUANT_MAX * QUANT_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _f32(min_calib_range, real), _f32(max_calib_range, real)
    else:
        mn, mx = torch.min(real), torch.max(real)
    amax = _amax(mn, mx)
    return _to_int8(real, _f32(QUANT_MAX, amax) / amax), mn, mx


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul_nt(a, b):
    """a @ b.T for int8 `a` (M, K) and `b` (N, K), accumulated exactly:
    int32 (M, N). On a card, ``torch._int_mm`` over zero-padded operands
    (rows above 16, depth and columns multiples of 8; `b` column-major,
    the layout cuBLASLt's int8 GEMM takes); elsewhere a float64 product
    of the integer values."""
    global INT8_GEMMS
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("int8_matmul_nt takes int8 operands, got %s and %s"
                        % (a.dtype, b.dtype))
    m, k = a.shape
    n = b.shape[0]
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ b.to(torch.float64).t()).to(
            torch.int32)
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    INT8_GEMMS += 1
    return out[:m, :n]


def _quantize_act(data, min_data, max_data):
    a_scale = _scale_of(min_data, max_data)
    return _to_int8(data, _f32(a_scale, data)), a_scale


def _rescale(acc, a_scale, w_scale):
    return _div_const(acc.to(torch.float32), a_scale * float(w_scale))


@register("_contrib_quantized_fully_connected", differentiable=False)
def _quantized_fc(data, weight, bias=None, num_hidden=0, no_bias=False,
                  flatten=True, min_data=0.0, max_data=0.0, w_scale=1.0):
    """int8 FullyConnected: the activation quantized with its calibrated
    range, an exact int8 x int8 contraction, rescaled to float32 (+ the
    float32 bias) (reference quantized_fully_connected.cc)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    q, a_scale = _quantize_act(data, min_data, max_data)
    lead = q.shape[:-1]
    acc = int8_matmul_nt(q.reshape(-1, q.shape[-1]), weight.to(torch.int8))
    out = _rescale(acc, a_scale, w_scale).reshape(lead + (acc.shape[-1],))
    if bias is not None and not no_bias:
        out = out + bias
    return out


def _im2col(x, kernel, stride, dilate, pad):
    """(N, C * prod(kernel), L) columns of `x` (N, C, *spatial), the
    column order (channel, kernel offsets) of a weight reshaped to
    (F, C * prod(kernel)), and the output's spatial shape."""
    nsp = len(kernel)
    if any(pad):
        x = F.pad(x, [p for p in reversed(pad) for _ in (0, 1)])
    out_sp = tuple((x.shape[2 + i] - dilate[i] * (kernel[i] - 1) - 1)
                   // stride[i] + 1 for i in range(nsp))
    taps = []
    for offs in itertools.product(*(range(k) for k in kernel)):
        sl = tuple(slice(o * d, o * d + s * (n - 1) + 1, s)
                   for o, d, s, n in zip(offs, dilate, stride, out_sp))
        taps.append(x[(slice(None), slice(None)) + sl])
    cols = torch.stack(taps, dim=2)          # (N, C, prod(K), *out)
    n, c = x.shape[:2]
    return cols.reshape(n, c * len(taps), -1), out_sp


@register("_contrib_quantized_conv", differentiable=False)
def _quantized_conv(data, weight, bias=None, kernel=(), stride=(),
                    dilate=(), pad=(), num_filter=0, num_group=1,
                    no_bias=False, layout="NCHW", min_data=0.0,
                    max_data=0.0, w_scale=1.0):
    """int8 convolution: int8 inputs, an exact int32 accumulator, rescaled
    to float32 (reference quantized_conv.cc)."""
    if layout not in ("NCW", "NCHW", "NCDHW"):
        raise ValueError("_contrib_quantized_conv supports channel-first "
                         "layouts only (got %r)" % (layout,))
    nsp = data.ndim - 2
    kernel = tuple(kernel) or tuple(weight.shape[2:])
    stride = tuple(stride) or (1,) * nsp
    dilate = tuple(dilate) or (1,) * nsp
    pad = tuple(pad) or (0,) * nsp
    q, a_scale = _quantize_act(data, min_data, max_data)
    cols, out_sp = _im2col(q, kernel, stride, dilate, pad)
    n, ck, length = cols.shape
    g = int(num_group)
    f = weight.shape[0]
    w = weight.to(torch.int8).reshape(g, f // g, ck // g)
    cols = cols.reshape(n, g, ck // g, length)
    accs = []
    for i in range(g):
        a = cols[:, i].transpose(1, 2).reshape(n * length, ck // g)
        acc = int8_matmul_nt(a, w[i])                 # (N * L, F / g)
        accs.append(acc.reshape(n, length, f // g).transpose(1, 2))
    acc = torch.cat(accs, dim=1).reshape((n, f) + out_sp)
    out = _rescale(acc, a_scale, w_scale)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return out
