"""Flash attention forward: exact blockwise attention with an online
softmax.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py`` (the forward half).
On the card, :func:`flash_attention_forward` launches the hand-written
Hopper kernel ``csrc/flash_attention_fwd.cu``, the port of the TPU
kernel ``_kernel``/``_flash_forward``. On the host it runs
:func:`flash_attention_reference`, a plain PyTorch version of the same
recurrence with the same mask constants: the port's counterpart of
Pallas interpret mode. A CUDA tensor always goes to the kernel, or the
call raises; nothing falls back to the plain version.

The backward kernels (``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``) come
with the training slice; until then a CUDA call that would need a
gradient raises ``NotImplementedError``.

Registered as ``_contrib_flash_attention`` (alias ``flash_attention``)
for ``mx.nd.contrib.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _native
from .registry import register

__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_reference", "LAUNCHES"]

_NEG = -1e30

# Kernel launches since import: flash_attention_forward adds one per
# launch of the CUDA kernel and nowhere else.
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128)


def _block_sizes(tq, tk, block_q, block_k):
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    if tq % block_q or tk % block_k:
        raise ValueError(
            "sequence lengths (%d, %d) must divide by blocks (%d, %d)"
            % (tq, tk, block_q, block_k))
    return block_q, block_k


def _check_inputs(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (batch, heads, seq, head_dim)")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError("incompatible q/k/v shapes %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share a device")


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              block_q=128, block_k=128):
    """Plain PyTorch version: the same blockwise recurrence as the TPU
    kernel, in fp32 whatever the input dtype. Returns (out, lse), out in
    the input dtype and lse fp32 of shape (batch, heads, seq_q)."""
    _check_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bq, bk = _block_sizes(tq, tk, block_q, block_k)
    scale = d ** -0.5 if scale is None else float(scale)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    for i in range(tq // bq):
        q_blk = qf[:, :, i * bq:(i + 1) * bq]
        m = torch.full((b, h, bq), _NEG, device=q.device)
        l = torch.zeros((b, h, bq), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for j in range(tk // bk):
            if causal and j * bk > (i + 1) * bq - 1:
                break  # this and every later k-block lie above the diagonal
            s = torch.matmul(q_blk, kf[:, :, j * bk:(j + 1) * bk]
                             .transpose(-1, -2)) * scale
            if causal:
                q_pos = i * bq + torch.arange(bq, device=q.device)
                k_pos = j * bk + torch.arange(bk, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = p * mask
            corr = torch.exp(m - m_new)
            m = m_new
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p, vf[:, :, j * bk:(j + 1) * bk])
        denom = torch.clamp_min(l, 1e-30)
        out[:, :, i * bq:(i + 1) * bq] = acc / denom[..., None]
        lse[:, :, i * bq:(i + 1) * bq] = m + torch.log(denom)
    return out.to(q.dtype), lse


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _native.load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_forward(q, k, v, causal=False, scale=None, block_q=128,
                            block_k=128):
    """Attention forward returning (out, lse).

    q: (batch, heads, seq_q, head_dim); k, v: (batch, heads, seq_k,
    head_dim). `block_q`/`block_k` keep the JAX op's contract (each must
    divide its sequence length after ``min(block, seq)``); the kernel's
    own tiles are independent of them. Host tensors run the plain
    version; CUDA tensors launch the kernel, which takes float32,
    bfloat16 and float16, head_dim 32, 64 or 128, contiguous inputs.
    """
    global LAUNCHES
    _check_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _block_sizes(tq, tk, block_q, block_k)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, block_q,
                                         block_k)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CPU or CUDA tensors, "
                         "got %s" % q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA has no backward yet: the TPU "
            "kernels K2 (_bwd_dkv_kernel) and K3 (_bwd_dq_kernel) of "
            "mxnet_tpu/ops/pallas_attention.py are not ported")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention kernel takes float32, bfloat16 "
                         "or float16, got %s" % q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head_dim in %s, "
                         "got %d" % (HEAD_DIMS, d))
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned "
                         "q, k, v")
    if b * h > 65535:
        raise ValueError("flash_attention kernel takes batch*heads <= "
                         "65535, got %d" % (b * h))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b * h, tq, tk, d,
                        _DTYPE_CODE[q.dtype], int(bool(causal)), scale,
                        stream)
    if err:
        raise RuntimeError("flash_attention_fwd kernel launch failed "
                           "(cudaError %d)" % err)
    LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """Blockwise exact attention (reference: pallas_attention.py
    flash_attention); returns the output only."""
    return flash_attention_forward(q, k, v, causal, scale, block_q,
                                   block_k)[0]


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(q, k, v, causal=False, scale=None, block_q=128,
                        block_k=128):
    # Slices of a packed (batch, 3, heads, seq, dim) array are strided
    # views; the op computes on dense copies (no-ops for dense inputs),
    # as the JAX package's arrays always are.
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale, block_q=block_q,
                           block_k=block_k)
