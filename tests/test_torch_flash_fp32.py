"""The fp32 flash-attention kernels' split-TF32 arithmetic, emulated on the
host and held against the JAX package's Pallas op.

The fp32 forward (K1), dK/dV (K2) and dQ (K3) kernels run on the tensor
cores in TF32, three products per matmul: each fp32 operand x is written as
hi + lo, hi = x with its low 13 mantissa bits cleared and lo = x - hi
cleared the same way, and a.b is ah.bh + ah.bl + al.bh with fp32
accumulation (mxnet_tpu_torch/csrc/hopper.cuh). The kernels cannot run
here, so these tests run their arithmetic: the same splits, the same
three products, P and dS split per tile as the kernels split them, the
forward's online softmax over the kernel's key tiles in base 2. The
emulation is held to the JAX op (interpret mode, as
tests/test_pallas_attention.py runs it) within
``kernel_tolerance(torch.float32)``, the JAX test's tolerance, and one
TF32 pass (hi.hi alone) is shown to miss it at the same inputs.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

RTOL, ATOL = tfa.kernel_tolerance(torch.float32, None)
LOG2E = 1.4426950408889634


def _tf32(x):
    """x with its low 13 mantissa bits cleared (tf32, truncated)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b as the kernels compute it: al.bh + ah.bl + ah.bh in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bl + al @ bh + ah @ bh


def _mm1(a, b):
    """a @ b in one TF32 pass: ah.bh."""
    return _tf32(a) @ _tf32(b)


def _fwd_keys(d):
    """Keys per tile of the fp32 forward kernel (flash_attention_fwd.cu,
    F32FwdGeo::kKeys)."""
    return 32 if d == 128 else 64


def emulate_forward(q, k, v, causal, mm=_mm3):
    """K1's fp32 arithmetic: per key tile, S = mm(Q, K^T) scaled into
    base 2, masked to -inf, an online max and sum, P = exp2(S - m) and
    O += mm(P, V); O = acc / max(l, 1e-30), LSE = m ln 2 + log(l)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    width = _fwd_keys(d)
    for k0 in range(0, tk, width):
        kt, vt = k[:, :, k0:k0 + width], v[:, :, k0:k0 + width]
        s = mm(q, kt.transpose(-1, -2)) * scale_log2
        if causal:
            live = torch.arange(tq)[:, None] >= \
                (k0 + torch.arange(kt.shape[2]))[None, :]
            s = s.masked_fill(~live, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p, vt)
        m = m_new
    denom = torch.clamp_min(l, 1e-30)
    return acc / denom[..., None], m * math.log(2.0) + torch.log(denom)


def emulate_bwd_dkv(q, k, v, out, lse, dout, causal, mm=_mm3):
    """K2's fp32 arithmetic: S^T = mm(K, Q^T), P^T = exp2(scale log2e S^T
    - lse log2e) (0 where masked), dP^T = mm(V, dO^T), dS^T = P^T (dP^T -
    delta) scale; dV = mm(P^T, dO), dK = mm(dS^T, Q)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    delta = (dout * out).sum(-1)
    st = mm(k, q.transpose(-1, -2))
    pt = torch.exp2(st * (scale * LOG2E) - (lse * LOG2E)[:, :, None, :])
    if causal:
        live = torch.arange(tk)[:, None] <= torch.arange(tq)[None, :]
        pt = pt * live
    dpt = mm(v, dout.transpose(-1, -2))
    dst = pt * (dpt - delta[:, :, None, :]) * scale
    return mm(dst, q), mm(pt, dout)


def _dq_keys(d):
    """Keys per tile of the fp32 dQ kernel (flash_attention_bwd.cu,
    F32DqGeo::kKeys)."""
    return 16 if d == 128 else 32


def emulate_bwd_dq(q, k, v, out, lse, dout, causal, mm=_mm3):
    """K3's fp32 arithmetic, tile by tile over the kernel's key tiles:
    S = mm(Q, K^T) and dP = mm(dO, V^T), P = exp2(scale log2e S - lse
    log2e) (0 where masked), dS = P (dP - delta) scale, split per tile,
    and dQ += mm(dS, K) accumulated in fp32."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    delta = (dout * out).sum(-1)
    lse_l2 = (lse * LOG2E)[..., None]
    dq = torch.zeros(q.shape)
    width = _dq_keys(d)
    for k0 in range(0, tk, width):
        kt, vt = k[:, :, k0:k0 + width], v[:, :, k0:k0 + width]
        p = torch.exp2(mm(q, kt.transpose(-1, -2)) * (scale * LOG2E) - lse_l2)
        if causal:
            p = p * (torch.arange(tq)[:, None] >=
                     (k0 + torch.arange(kt.shape[2]))[None, :])
        ds = p * (mm(dout, vt.transpose(-1, -2)) - delta[..., None]) * scale
        dq = dq + mm(ds, kt)
    return dq


def _inputs(seed, shape_q, shape_k):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in (shape_q, shape_k, shape_k, shape_q)]


def _jax_forward(q, k, v, causal, block):
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_attention as jfa

    out, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q.shape[3] ** -0.5,
        causal, block[0], block[1], True)
    return np.asarray(out), np.asarray(lse)


def _jax_grads(q, k, v, g, causal, block):
    """(dq, dk, dv) of the Pallas op by jax.vjp, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_attention as jfa

    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                            block_q=block[0],
                                            block_k=block[1]),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


def _violation(got, want, rows=None):
    """max(|got - want| - (atol + rtol |want|)) over `rows` of the
    sequence axis (all rows if None); <= 0 means within tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    if rows is not None:
        got, want = got[..., rows, :], want[..., rows, :]
    return float((np.abs(got - want) - (ATOL + RTOL * np.abs(want))).max())


# (shape_q, shape_k, causal): head dims 32, 64 (two key tiles of 64) and
# 128 (tiles of 32), Tq != Tk, a ragged T of 200 (no multiple of a tile).
SMALL = [
    ((1, 2, 128, 32), (1, 2, 128, 32), True),
    ((1, 2, 128, 64), (1, 2, 128, 64), True),
    ((1, 2, 128, 64), (1, 2, 128, 64), False),
    ((1, 2, 64, 64), (1, 2, 192, 64), False),
    ((1, 2, 64, 64), (1, 2, 192, 64), True),
    ((1, 2, 200, 64), (1, 2, 200, 64), True),
    ((1, 2, 96, 128), (1, 2, 96, 128), True),
    ((1, 2, 64, 128), (1, 2, 128, 128), False),
]


def _block(shape_q, shape_k):
    return (32 if shape_q[2] % 32 == 0 else 8,
            32 if shape_k[2] % 32 == 0 else 8)


@pytest.mark.parametrize("shape_q,shape_k,causal", SMALL)
def test_split_tf32_forward_matches_jax(shape_q, shape_k, causal):
    """K1's split-TF32 emulation against the Pallas forward: O and LSE
    within kernel_tolerance(float32)."""
    q, k, v, _ = _inputs(30, shape_q, shape_k)
    want_out, want_lse = _jax_forward(q, k, v, causal, _block(shape_q,
                                                               shape_k))
    out, lse = emulate_forward(*map(torch.from_numpy, (q, k, v)), causal)
    assert _violation(out, want_out) <= 0
    assert _violation(lse[..., None], want_lse[..., None]) <= 0


@pytest.mark.parametrize("shape_q,shape_k,causal", SMALL)
def test_split_tf32_dkv_matches_jax_vjp(shape_q, shape_k, causal):
    """K2's split-TF32 emulation, from the emulated forward's O and LSE,
    against jax.vjp of the Pallas op: dK and dV within
    kernel_tolerance(float32)."""
    q, k, v, g = _inputs(31, shape_q, shape_k)
    _, want_dk, want_dv = _jax_grads(q, k, v, g, causal,
                                     _block(shape_q, shape_k))
    tq_, tk_, tv_, tg_ = map(torch.from_numpy, (q, k, v, g))
    out, lse = emulate_forward(tq_, tk_, tv_, causal)
    dk, dv = emulate_bwd_dkv(tq_, tk_, tv_, out, lse, tg_, causal)
    assert _violation(dk, want_dk) <= 0
    assert _violation(dv, want_dv) <= 0


@pytest.mark.parametrize("shape_q,shape_k,causal", SMALL)
def test_split_tf32_dq_matches_jax_vjp(shape_q, shape_k, causal):
    """K3's split-TF32 emulation over its own key tiles (32 keys, 16 at
    head dim 128), from the emulated forward's O and LSE, against
    jax.vjp of the Pallas op: dQ within kernel_tolerance(float32)."""
    q, k, v, g = _inputs(34, shape_q, shape_k)
    want_dq, _, _ = _jax_grads(q, k, v, g, causal, _block(shape_q, shape_k))
    tq_, tk_, tv_, tg_ = map(torch.from_numpy, (q, k, v, g))
    out, lse = emulate_forward(tq_, tk_, tv_, causal)
    dq = emulate_bwd_dq(tq_, tk_, tv_, out, lse, tg_, causal)
    assert _violation(dq, want_dq) <= 0


# A few rows of the serving/training geometry: T 2048, head dim 64,
# causal: the first and last rows and two between.
LONG = ((1, 1, 2048, 64), (1, 1, 2048, 64))
LONG_ROWS = [0, 777, 1500, 2047]


@pytest.fixture(scope="module")
def long_case():
    q, k, v, g = _inputs(32, *LONG)
    want_out, want_lse = _jax_forward(q, k, v, True, (512, 512))
    want_dq, want_dk, want_dv = _jax_grads(q, k, v, g, True, (512, 512))
    return (q, k, v, g), (want_out, want_lse, want_dk, want_dv, want_dq)


LONG_OUTPUTS = ["out", "lse", "dk", "dv", "dq"]


def _long_emulation(case, mm):
    """(out, lse, dk, dv, dq) of the emulated kernels at T 2048. dQ is
    computed on LONG_ROWS' queries alone (each sees every key up to its
    own), from the full forward's O and LSE."""
    (q, k, v, g), _ = case
    tq_, tk_, tv_, tg_ = map(torch.from_numpy, (q, k, v, g))
    out, lse = emulate_forward(tq_, tk_, tv_, True, mm)
    dk, dv = emulate_bwd_dkv(tq_, tk_, tv_, out, lse, tg_, True, mm)
    dq = torch.zeros(tq_.shape)
    for r in LONG_ROWS:
        rows = slice(r, r + 1)
        # One query row at absolute position r: causal against keys <= r.
        dq[:, :, rows] = emulate_bwd_dq(
            tq_[:, :, rows], tk_[:, :, :r + 1], tv_[:, :, :r + 1],
            out[:, :, rows], lse[:, :, rows], tg_[:, :, rows], False, mm)
    return out, lse, dk, dv, dq


@pytest.mark.parametrize("which", LONG_OUTPUTS)
def test_split_tf32_holds_at_t2048(long_case, which):
    """At T 2048 the three-product emulation stays within
    kernel_tolerance(float32) of the JAX op on the chosen rows."""
    got = _long_emulation(long_case, _mm3)
    i = LONG_OUTPUTS.index(which)
    g, w = got[i].numpy(), long_case[1][i]
    if which == "lse":
        g, w = g[..., None], w[..., None]
    assert _violation(g, w, LONG_ROWS) <= 0


def test_one_tf32_pass_misses_the_tolerance(long_case):
    """The same inputs through one TF32 pass (hi.hi alone) miss
    kernel_tolerance(float32): the lo products are what hold it."""
    out, _, dk, dv, _ = _long_emulation(long_case, _mm1)
    want_out, _, want_dk, want_dv, _ = long_case[1]
    assert max(_violation(out, want_out, LONG_ROWS),
               _violation(dk, want_dk, LONG_ROWS),
               _violation(dv, want_dv, LONG_ROWS)) > 0


def test_one_tf32_pass_misses_dq_at_t2048(long_case):
    """K3 alone: dQ through one TF32 pass misses kernel_tolerance(float32)
    on LONG_ROWS at T 2048, where the three-product dQ holds it."""
    dq = _long_emulation(long_case, _mm1)[4]
    assert _violation(dq, long_case[1][4], LONG_ROWS) > 0


@pytest.mark.parametrize("shape_q,shape_k,causal", SMALL[:4])
def test_one_tf32_pass_misses_at_small_shapes(shape_q, shape_k, causal):
    """One TF32 pass misses the tolerance at the small shapes too (the
    forward or dK/dV), where the three-product emulation holds it."""
    q, k, v, g = _inputs(31, shape_q, shape_k)
    want_out, _ = _jax_forward(q, k, v, causal, _block(shape_q, shape_k))
    _, want_dk, want_dv = _jax_grads(q, k, v, g, causal,
                                     _block(shape_q, shape_k))
    tq_, tk_, tv_, tg_ = map(torch.from_numpy, (q, k, v, g))
    out, lse = emulate_forward(tq_, tk_, tv_, causal, _mm1)
    dk, dv = emulate_bwd_dkv(tq_, tk_, tv_, out, lse, tg_, causal, _mm1)
    assert max(_violation(out, want_out), _violation(dk, want_dk),
               _violation(dv, want_dv)) > 0


@pytest.mark.parametrize("shape_q,shape_k,causal", SMALL[:4])
def test_one_tf32_pass_misses_dq_at_small_shapes(shape_q, shape_k, causal):
    """K3 alone at the small shapes: dQ through one TF32 pass misses the
    tolerance where the three-product dQ
    (test_split_tf32_dq_matches_jax_vjp) holds it."""
    q, k, v, g = _inputs(34, shape_q, shape_k)
    want_dq, _, _ = _jax_grads(q, k, v, g, causal, _block(shape_q, shape_k))
    tq_, tk_, tv_, tg_ = map(torch.from_numpy, (q, k, v, g))
    out, lse = emulate_forward(tq_, tk_, tv_, causal)
    dq = emulate_bwd_dq(tq_, tk_, tv_, out, lse, tg_, causal, _mm1)
    assert _violation(dq, want_dq) > 0


def test_split_is_exact_to_the_dropped_term():
    """hi + lo reproduces x to lo's own truncation (below 2^-20 |x|), and
    both halves are tf32 values (low 13 bits clear)."""
    x = torch.from_numpy(np.random.RandomState(33).randn(4096)
                         .astype(np.float32)) * 3.0
    hi, lo = _split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 8191).abs().max()) == 0
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -20
