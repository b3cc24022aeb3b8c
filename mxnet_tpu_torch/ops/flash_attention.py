"""Flash attention: exact blockwise attention with an online softmax,
and its backward regenerating the probabilities from the saved
log-sum-exp.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``. Three kernels:

- :func:`flash_attention_forward` launches ``csrc/flash_attention_fwd.cu``
  (K1, the port of ``_kernel``/``_flash_forward``);
- :func:`flash_attention_backward` computes delta = rowsum(dO * O) in
  fp32 and launches ``csrc/flash_attention_bwd.cu`` twice: the dK/dV
  pass (K2, the port of ``_bwd_dkv_kernel``) and then the dQ pass (K3,
  ``_bwd_dq_kernel``).

All three run bf16/fp16 inputs on the tensor cores (wgmma fed by TMA).
fp32 inputs run all three on the tensor cores too, in split TF32 (three
TF32 products per fp32 product, after a pre-pass into a workspace the
launcher allocates). The library chooses by the input dtype; nothing
falls back from one to another.
:func:`kernel_tolerance` is the one rule a kernel's output is held to
against its plain version.

A ``torch.autograd.Function`` ties them together as the JAX op's
``custom_vjp`` does: the forward saves (q, k, v, out, lse), O(T·d), and
the backward returns (dq, dk, dv). :func:`flash_attention` and the
registered op go through it.

On the host each launcher runs its plain PyTorch version
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`), the same blockwise
recurrences with the same mask constants: the port's counterpart of
Pallas interpret mode. A CUDA tensor always goes to the kernels, or the
call raises; nothing falls back to the plain versions.

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
           "flash_attention_backward", "flash_attention_reference",
           "flash_attention_backward_reference",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_dq_reference", "launch_bwd_dkv",
           "launch_bwd_dq", "kernel_tolerance", "backward_atol_floor",
           "FlashAttentionFunction",
           "LAUNCHES",
           "LAUNCHES_BWD_DKV", "LAUNCHES_BWD_DQ"]

_NEG = -1e30

# Kernel launches since import, each added to where its CUDA kernel is
# launched and nowhere else: K1 (forward), K2 (dK/dV), K3 (dQ). One count
# is one call of the C entry point. On fp32 inputs that call launches the
# split pre-pass first (once for K1, on V; twice for K2, on Q and dO; once
# for K3, on K) and then the kernel, on one stream: the count covers them
# together.
LAUNCHES = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128)


# Unit roundoff (half an ulp, relative) of the 16-bit input dtypes:
# bf16 keeps 8 significant bits, fp16 11.
_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def kernel_tolerance(dtype, want, floor=0.0):
    """(rtol, atol) of a kernel's output against its plain version.

    float32: the JAX package's test tolerance (rtol 2e-4, atol 2e-5).
    K1-K3 run split TF32 on the tensor cores: each operand x = hi + lo,
    hi its top 19 bits and lo = x - hi truncated the same way, and a.b =
    ah.bh + ah.bl + al.bh in fp32. The dropped al.bl and lo's truncation
    leave about 2^-20 of |a.b| per product (fp32 itself: 2^-24), far
    inside rtol 2e-4 (about 2^-12); one TF32 pass (2^-11) is not. The host
    tests emulate the split (tests/test_torch_flash_fp32.py) and
    chip_smoke.py logs the largest share of this tolerance each kernel
    uses on the card. `floor` does not apply.

    bfloat16/float16, with u the dtype's unit roundoff (2^-8, 2^-11):
    - rtol 2u: the kernel and the plain version each round their fp32
      result once to the dtype, half an ulp at most;
    - atol 1e-3 of the tensor's largest entry for the fp32 summation
      order, plus u times the largest entry: the tensor cores multiply
      16-bit operands, so the kernels round P (K1, K2) and dS (K2, K3)
      to the dtype before the second product (O += P V, dV += P^T dO,
      dK += dS^T Q, dQ += dS K), where the plain versions keep them in
      fp32. Each term of those sums then carries a relative error of at
      most u, with random sign, so the sum should be off by about u
      times the root sum of squares of its terms, below u times the
      largest entry the sum reaches. That is an estimate, not a bound:
      the host tests emulate the rounding against it, and the card's
      readings are in PERF.md. Without the term, non-causal bf16 at
      T 2048 misses by one ulp.
    - atol is at least `floor`, the backward's rounding noise where the
      exact gradient is zero (:func:`backward_atol_floor`): both terms
      above scale with the largest entry of `want`, and are zero where
      `want` is. A call that gives no floor keeps the terms alone.
    """
    if dtype == torch.float32:
        return 2e-4, 2e-5
    u = _UNIT_ROUNDOFF[dtype]
    return 2 * u, max((1e-3 + u) * float(want.float().abs().max()),
                      float(floor))


def backward_atol_floor(q, k, v, dout, lse, causal=False, scale=None):
    """(dq, dk, dv) atol floors of the backward kernels against their
    plain versions, from the inputs alone (q, k, v, dout, and the
    forward's lse): the rounding noise the two versions leave where the
    exact gradient is zero. For :func:`kernel_tolerance`'s `floor`.

    dS_ij = P_ij (dP_ij - delta_i) scale. dP_ij = dO_i . v_j is a sum of D
    products, each at most m = max|dO| max|V| in size; the kernel and the
    plain version compute it in fp32 in their own orders, each off by
    about D 2^-24 m (fp32's unit roundoff times the largest sum of
    magnitudes), so their dP - delta (delta is the same tensor in both)
    differ by up to e = 2 D 2^-24 m. Attention over one key is the case
    where that is all there is: P = 1 and dP = delta exactly, so dS, dQ
    and dK are exactly zero and both versions return the noise.
    - dQ_i = sum_j dS_ij K_j carries it as scale e sum_j P_ij |K_j| <=
      scale e max|K|: a row of P sums to 1.
    - dK_j = sum_i dS_ij Q_i carries it as scale e sum_i P_ij |Q_i| <=
      scale e max|Q| c, c the largest column sum of P (computed here from
      q, k and lse by blocks of 256 queries: one pass of Q K^T, as the
      plain versions make). A column's sum is at most Tq, a bound
      that grows with Tq where the existing atol does not.
    - dV_j = sum_i P_ij dO_i has no such cancellation: 0.
    The noise, not a wider bound: where the exact gradient is not zero
    the existing atol is the larger (tests/test_torch_flash_attention.py
    shows it at the host and card shapes; chip_smoke.py on the card).
    """
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    qf, kf = q.float(), k.float()
    tq, tk = q.shape[2], k.shape[2]
    e = 2 * d * 2.0 ** -24 * float(dout.float().abs().max()) * \
        float(v.float().abs().max())
    mass = torch.zeros(qf.shape[:2] + (tk,), device=q.device)
    keys = torch.arange(tk, device=q.device)
    for i0 in range(0, tq, 256):
        s = torch.matmul(qf[:, :, i0:i0 + 256], kf.transpose(-1, -2))
        p = torch.exp(s * scale - lse[:, :, i0:i0 + 256, None].float())
        if causal:
            rows = i0 + torch.arange(s.shape[2], device=q.device)
            p = p * (rows[:, None] >= keys[None, :])
        mass += p.sum(-2)
    return (scale * e * float(kf.abs().max()),
            scale * e * float(qf.abs().max()) * float(mass.max()), 0.0)


def _resolve(q, k, v, scale, block_q, block_k):
    """Check (q, k, v) and the JAX op's block contract (each block must
    divide its sequence length after ``min(block, seq)``); returns
    (scale, block_q, block_k) with the default scale ``head_dim**-0.5``."""
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
    tq, tk = q.shape[2], k.shape[2]
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    if tq % block_q or tk % block_k:
        raise ValueError(
            "sequence lengths (%d, %d) must divide by blocks (%d, %d)"
            % (tq, tk, block_q, block_k))
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    return scale, block_q, block_k


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              block_q=128, block_k=128):
    """Plain PyTorch version: the same blockwise recurrence as the TPU
    kernel, in fp32 whatever the input dtype. Returns (out, lse), out in
    the input dtype and lse fp32 of shape (batch, heads, seq_q)."""
    scale, bq, bk = _resolve(q, k, v, scale, block_q, block_k)
    b, h, tq, d = q.shape
    tk = k.shape[2]
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


def _regen(qf, kf, vf, dof, lse, delta, i, j, bq, bk, causal, scale):
    """One (q block i, k block j) of the backward's recompute, in fp32:
    (p, ds) with p = exp(s - lse) and ds = p * (dp - delta) * scale —
    the TPU kernels' shared ``_regen``."""
    q_blk = qf[:, :, i * bq:(i + 1) * bq]
    s = torch.matmul(q_blk, kf[:, :, j * bk:(j + 1) * bk]
                     .transpose(-1, -2)) * scale
    if causal:
        q_pos = i * bq + torch.arange(bq, device=qf.device)
        k_pos = j * bk + torch.arange(bk, device=qf.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full_like(s, _NEG))
    p = torch.exp(s - lse[:, :, i * bq:(i + 1) * bq, None])
    dp = torch.matmul(dof[:, :, i * bq:(i + 1) * bq],
                      vf[:, :, j * bk:(j + 1) * bk].transpose(-1, -2))
    ds = p * (dp - delta[:, :, i * bq:(i + 1) * bq, None]) * scale
    return p, ds


def _delta(out, dout):
    """delta_i = rowsum(dO_i * O_i) in fp32, (batch, heads, seq_q)."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)


def flash_attention_bwd_dkv_reference(q, k, v, out, lse, dout, causal=False,
                                      scale=None, block_q=128, block_k=128):
    """Plain version of K2: per k block, over the q blocks that reach
    it, dV += p^T dO and dK += ds^T q in fp32. Returns (dk, dv) in the
    input dtype."""
    scale, bq, bk = _resolve(q, k, v, scale, block_q, block_k)
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, dout))
    delta = _delta(out, dout)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j in range(kf.shape[2] // bk):
        for i in range(qf.shape[2] // bq):
            if causal and (i + 1) * bq - 1 < j * bk:
                continue  # this q block lies wholly above the diagonal
            p, ds = _regen(qf, kf, vf, dof, lse, delta, i, j, bq, bk,
                           causal, scale)
            dv[:, :, j * bk:(j + 1) * bk] += torch.matmul(
                p.transpose(-1, -2), dof[:, :, i * bq:(i + 1) * bq])
            dk[:, :, j * bk:(j + 1) * bk] += torch.matmul(
                ds.transpose(-1, -2), qf[:, :, i * bq:(i + 1) * bq])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, out, lse, dout, causal=False,
                                     scale=None, block_q=128, block_k=128):
    """Plain version of K3: per q block, over the k blocks up to the
    diagonal, dQ += ds k in fp32. Returns dq in the input dtype."""
    scale, bq, bk = _resolve(q, k, v, scale, block_q, block_k)
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, dout))
    delta = _delta(out, dout)
    dq = torch.zeros_like(qf)
    for i in range(qf.shape[2] // bq):
        for j in range(kf.shape[2] // bk):
            if causal and j * bk > (i + 1) * bq - 1:
                break  # this and every later k block lie above it
            _, ds = _regen(qf, kf, vf, dof, lse, delta, i, j, bq, bk,
                           causal, scale)
            dq[:, :, i * bq:(i + 1) * bq] += torch.matmul(
                ds, kf[:, :, j * bk:(j + 1) * bk])
    return dq.to(q.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal=False, scale=None,
                                       block_q=128, block_k=128):
    """Plain PyTorch version of the backward, K3's dq and K2's (dk, dv)
    in the input dtype, by the same blockwise regeneration in fp32."""
    args = (q, k, v, out, lse, dout, causal, scale, block_q, block_k)
    dk, dv = flash_attention_bwd_dkv_reference(*args)
    return flash_attention_bwd_dq_reference(*args), dk, dv


def _workspace_fn(lib, name):
    """`name`(bh, tq, tk, d, dtype) -> bytes of scratch a launch needs."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_size_t
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _native.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _workspace_fn(lib, "flash_attention_fwd_workspace")


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    """{"dkv", "dq"}: (entry point, its workspace-bytes function)."""
    lib = _native.load("flash_attention_bwd")
    out = {}
    for which, n_ptrs in (("dkv", 8), ("dq", 7)):
        fn = getattr(lib, "flash_attention_bwd_" + which)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[which] = fn, _workspace_fn(
            lib, "flash_attention_bwd_%s_workspace" % which)
    return out


def _workspace(nbytes, device):
    """Scratch of the fp32 route's split pre-pass (None when a launch
    needs none): a byte tensor whose pointer the kernel is given."""
    if not nbytes:
        return None
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _launch(name, fn, q, workspace_bytes, *args):
    """Call the C entry point `fn`(*args, workspace, stream) on q's
    device and current stream, with `workspace_bytes` of scratch
    allocated there; raise, naming the kernel, the dtype and the head
    dim, if it returns a cudaError."""
    ws = _workspace(workspace_bytes, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, None if ws is None else ws.data_ptr(), stream)
    if err:
        raise RuntimeError(
            "%s kernel launch failed for %s, head_dim %d (cudaError %d)"
            % (name, str(q.dtype).split(".")[1], q.shape[-1], err))


def _check_kernel_inputs(tensors, b, h):
    """What the CUDA kernels take: float32/bfloat16/float16, head_dim
    32, 64 or 128, contiguous 16-byte aligned tensors."""
    q = tensors[0]
    d = q.shape[-1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention kernel takes float32, bfloat16 "
                         "or float16, got %s" % q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head_dim in %s, "
                         "got %d" % (HEAD_DIMS, d))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention kernel needs 16-byte aligned "
                         "inputs")
    if b * h > 65535:
        raise ValueError("flash_attention kernel takes batch*heads <= "
                         "65535, got %d" % (b * h))


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
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, block_q,
                                         block_k)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CPU or CUDA tensors, "
                         "got %s" % q.device)
    scale, _, _ = _resolve(q, k, v, scale, block_q, block_k)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _check_kernel_inputs((q, k, v), b, h)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0:
        return out, lse
    fn, workspace_bytes = _kernel()
    code = _DTYPE_CODE[q.dtype]
    _launch("flash_attention_fwd", fn, q,
            workspace_bytes(b * h, tq, tk, d, code),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, code, int(bool(causal)), scale)
    LAUNCHES += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, causal=False,
                             scale=None, block_q=128, block_k=128):
    """(dq, dk, dv) of attention from the forward's (out, lse) and the
    output gradient `dout`, in the input dtype.

    Host tensors run the plain version; CUDA tensors compute delta in
    fp32 and launch K2 (dK/dV) then K3 (dQ), which take what the forward
    kernel takes. `dout` is made contiguous and cast to the input dtype.
    """
    dout = dout.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal, scale, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CPU or CUDA tensors, "
                         "got %s" % q.device)
    scale, _, _ = _resolve(q, k, v, scale, block_q, block_k)
    if q.shape[2] == 0 or k.shape[2] == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    lse = lse.contiguous()
    delta = _delta(out, dout).contiguous()
    dk, dv = launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    dq = launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


def _bwd_args(q, k, v, dout, lse, delta, causal, scale):
    """Checked pointer and shape arguments of the backward kernels."""
    b, h, tq, d = q.shape
    _check_kernel_inputs((q, k, v, dout, lse, delta), b, h)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            lse.shape != (b, h, tq) or delta.shape != (b, h, tq) or \
            lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash_attention backward: dout must match q, "
                         "lse and delta be fp32 (batch, heads, seq_q)")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    shape = (b * h, tq, k.shape[2], d, _DTYPE_CODE[q.dtype],
             int(bool(causal)), float(scale))
    return ptrs, shape


def launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale):
    """Launch K2 on CUDA tensors: (dk, dv) in the input dtype. `delta`
    is rowsum(dout * out) in fp32, shaped like `lse`."""
    global LAUNCHES_BWD_DKV
    ptrs, shape = _bwd_args(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn, workspace_bytes = _bwd_kernels()["dkv"]
    _launch("flash_attention_bwd_dkv", fn, q, workspace_bytes(*shape[:5]),
            *ptrs, dk.data_ptr(), dv.data_ptr(), *shape)
    LAUNCHES_BWD_DKV += 1
    return dk, dv


def launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """Launch K3 on CUDA tensors: dq in the input dtype. `delta` as for
    :func:`launch_bwd_dkv`."""
    global LAUNCHES_BWD_DQ
    ptrs, shape = _bwd_args(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    fn, workspace_bytes = _bwd_kernels()["dq"]
    _launch("flash_attention_bwd_dq", fn, q, workspace_bytes(*shape[:5]),
            *ptrs, dq.data_ptr(), *shape)
    LAUNCHES_BWD_DQ += 1
    return dq


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward, K2/K3 backward (the JAX op's ``custom_vjp``,
    pallas_attention.py:297-317): saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = flash_attention_forward(q, k, v, causal, scale, block_q,
                                           block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.params = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              *ctx.params)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """Blockwise exact attention (reference: pallas_attention.py
    flash_attention); returns the output only, differentiable in q, k
    and v."""
    return FlashAttentionFunction.apply(q, k, v, causal, scale, block_q,
                                        block_k)


def _flash_attention_shapes(attrs, in_shapes):
    """Shape rule of the op (``Symbol.infer_shape`` takes it instead of a
    run on meta tensors, which the kernels' wrappers refuse): the output
    has q's (batch, heads, query length) and v's head dim."""
    q, _, v = in_shapes
    if q is None:
        raise ValueError("flash_attention needs the shape of q")
    return list(in_shapes), [tuple(q[:-1]) + (tuple(v)[-1] if v is not None
                                              else q[-1],)]


@register("_contrib_flash_attention", aliases=("flash_attention",),
          infer_shape=_flash_attention_shapes)
def _flash_attention_op(q, k, v, causal=False, scale=None, block_q=128,
                        block_k=128):
    # Slices of a packed (batch, 3, heads, seq, dim) array are strided
    # views; the op computes on dense copies (no-ops for dense inputs),
    # as the JAX package's arrays always are.
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale, block_q=block_q,
                           block_k=block_k)
