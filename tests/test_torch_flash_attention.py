"""mxnet_tpu_torch flash attention against the JAX package's Pallas op.

On the host the port runs its plain PyTorch versions; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_pallas_attention.py
runs them. Same numpy inputs, fp32, the JAX test's tolerance (rtol 2e-4,
atol 2e-5), for the forward and for the gradients (dq, dk, dv against
`jax.vjp` of the op). The kernels themselves are compared with the
plain versions on the card by the `cuda`-marked tests, which skip here.
This module imports JAX only inside the tests that compare with it, so
that the card tests also run where JAX is not installed (see README.md).
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed, shape_q, shape_k):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_k).astype(np.float32),
            rng.randn(*shape_k).astype(np.float32))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax():
    """(jax.numpy, the JAX package's pallas_attention module)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_attention

    return jnp, pallas_attention


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(causal):
    jnp, jfa = _jax()
    q, k, v = _qkv(0, (2, 2, 64, 16), (2, 2, 64, 16))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=16,
                               block_k=16)
    got = tfa.flash_attention(*_torch(q, k, v), causal=causal, block_q=16,
                              block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_matches_pallas_interpret(causal):
    jnp, jfa = _jax()
    q, k, v = _qkv(4, (1, 2, 16, 8), (1, 2, 48, 8))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=8,
                               block_k=16)
    got = tfa.flash_attention(*_torch(q, k, v), causal=causal, block_q=8,
                              block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_pallas_forward(causal):
    jnp, jfa = _jax()
    q, k, v = _qkv(5, (2, 2, 64, 16), (2, 2, 64, 16))
    want_out, want_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16 ** -0.5, causal,
        16, 16, True)
    got_out, got_lse = tfa.flash_attention_forward(
        *_torch(q, k, v), causal=causal, block_q=16, block_k=16)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, 2, 64)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=RTOL, atol=ATOL)


def test_explicit_scale_matches():
    jnp, jfa = _jax()
    q, k, v = _qkv(6, (1, 2, 32, 8), (1, 2, 32, 8))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, scale=0.5,
                               block_q=16, block_k=16)
    got = tfa.flash_attention(*_torch(q, k, v), causal=True, scale=0.5,
                              block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_uneven_blocks_rejected():
    q = torch.from_numpy(np.random.RandomState(1).randn(1, 1, 48, 8)
                         .astype(np.float32))
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention(q, q, q, block_q=32, block_k=32)


def test_mismatched_inputs_rejected():
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.to(torch.float64), q)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 1, 16, 4), q)


def test_nd_contrib_surface_is_the_port_op():
    """mx.nd.contrib.flash_attention resolves `_contrib_flash_attention`
    of the port's registry and agrees with the JAX op."""
    from mxnet_tpu_torch.ops import registry

    assert registry.get("_contrib_flash_attention") is \
        registry.get("flash_attention")
    assert registry.get("_contrib_flash_attention").fn.__module__ == \
        "mxnet_tpu_torch.ops.flash_attention"
    rng = np.random.RandomState(3)
    x = rng.randn(1, 2, 32, 8).astype(np.float32)
    with mx.cpu():
        q = mx.nd.array(x)
        out = mx.nd.contrib.flash_attention(q, q, q, causal=True,
                                            block_q=16, block_k=16)
    assert isinstance(out, mx.nd.NDArray) and out.context == mx.cpu()
    import mxnet_tpu as jmx

    want = jmx.nd.contrib.flash_attention(jmx.nd.array(x), jmx.nd.array(x),
                                          jmx.nd.array(x), causal=True,
                                          block_q=16, block_k=16)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)


def test_packed_strided_slices_through_the_op():
    """The served function slices q, k, v out of one packed array; the
    op takes the strided views."""
    jnp, jfa = _jax()
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 2, 32, 8).astype(np.float32)
    with mx.cpu():
        packed = mx.nd.array(x)
        out = mx.nd.contrib.flash_attention(packed[:, 0], packed[:, 1],
                                            packed[:, 2], causal=True)
    want = jfa.flash_attention(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]),
                               jnp.asarray(x[:, 2]), causal=True)
    np.testing.assert_allclose(out.asnumpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- the tensor-core kernels' rounding, emulated on the host -------------------

def _inputs16(seed, shape_q, shape_k, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
                 for s in (shape_q, shape_k, shape_k, shape_q))


def _rounded(x, dtype):
    """x rounded to `dtype` and widened back: what the tensor cores see
    of an fp32 value packed as a 16-bit operand."""
    return x.to(dtype).to(torch.float32)


def _mask(tq, tk, k0, width):
    """(tq, width) live mask of keys k0..k0+width-1, causal top-left."""
    return torch.arange(tq)[:, None] >= (k0 + torch.arange(width))[None, :]


def _emulate_wgmma_forward(q, k, v, causal, tile=128):
    """The bf16/fp16 forward kernel's arithmetic on the host: fp32 online
    softmax over 128-key tiles, P rounded to the input dtype before
    O += P V, the row sum l from the unrounded P."""
    dt = q.dtype
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    tq, tk = q.shape[2], k.shape[2]
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, tk, tile):
        s = torch.matmul(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~_mask(tq, tk, k0, s.shape[-1]), -float("inf"))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(_rounded(p, dt),
                                                   vf[:, :, k0:k0 + tile])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dt)


def _emulate_wgmma_bwd_dkv(q, k, v, out, lse, dout, causal):
    """The bf16/fp16 dK/dV kernel's arithmetic on the host: P^T and dS^T
    in fp32, each rounded to the input dtype before dV += P^T dO and
    dK += dS^T Q."""
    dt = q.dtype
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    delta = (dof * out.to(torch.float32)).sum(-1)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    if causal:
        p = p * _mask(q.shape[2], k.shape[2], 0, k.shape[2])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) \
        * scale
    dv = torch.matmul(_rounded(p, dt).transpose(-1, -2), dof)
    dk = torch.matmul(_rounded(ds, dt).transpose(-1, -2), qf)
    return dk.to(dt), dv.to(dt)


def _emulate_wgmma_bwd_dq(q, k, v, out, lse, dout, causal):
    """The bf16/fp16 dQ kernel's arithmetic on the host: dS in fp32,
    rounded to the input dtype before dQ += dS K, in fp32."""
    dt = q.dtype
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    delta = (dof * out.to(torch.float32)).sum(-1)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    if causal:
        p = p * _mask(q.shape[2], k.shape[2], 0, k.shape[2])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) \
        * scale
    return torch.matmul(_rounded(ds, dt), kf).to(dt)


EMULATED = [(dt, d, causal) for dt in ("bfloat16", "float16")
            for d in (64, 128) for causal in (False, True)]


@pytest.mark.parametrize("dtype,head_dim,causal", EMULATED)
def test_kernel_tolerance_covers_rounded_p_forward(dtype, head_dim, causal):
    """The forward kernel rounds P to bf16/fp16 for the tensor cores; its
    emulation stays within kernel_tolerance of the fp32 plain version
    at T 2048 (non-causal bf16 misses the rule without the P term)."""
    dt = getattr(torch, dtype)
    q, k, v, _ = _inputs16(20, (1, 2, 2048, head_dim), (1, 2, 2048, head_dim),
                           dt)
    want, _ = tfa.flash_attention_reference(q, k, v, causal=causal,
                                            block_q=512, block_k=512)
    got = _emulate_wgmma_forward(q, k, v, causal)
    rtol, atol = tfa.kernel_tolerance(dt, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype,head_dim,causal", EMULATED)
def test_kernel_tolerance_covers_rounded_p_and_ds_backward(dtype, head_dim,
                                                          causal):
    """The dK/dV kernel rounds P^T and dS^T to bf16/fp16; its emulation
    stays within kernel_tolerance of the fp32 plain K2."""
    dt = getattr(torch, dtype)
    shape = (1, 2, 1024, head_dim)
    q, k, v, g = _inputs16(21, shape, shape, dt)
    out, lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             block_q=512, block_k=512)
    want = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, out, lse, g, causal=causal, block_q=512, block_k=512)
    got = _emulate_wgmma_bwd_dkv(q, k, v, out, lse, g, causal)
    for name, a, b in zip(("dk", "dv"), got, want):
        rtol, atol = tfa.kernel_tolerance(dt, b)
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))


@pytest.mark.parametrize("dtype,head_dim,causal", EMULATED)
def test_kernel_tolerance_covers_rounded_ds_dq(dtype, head_dim, causal):
    """The dQ kernel rounds dS to bf16/fp16 before dQ += dS K; its
    emulation stays within kernel_tolerance of the fp32 plain K3."""
    dt = getattr(torch, dtype)
    shape = (1, 2, 1024, head_dim)
    q, k, v, g = _inputs16(22, shape, shape, dt)
    out, lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             block_q=512, block_k=512)
    want = tfa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, g, causal=causal, block_q=512, block_k=512)
    got = _emulate_wgmma_bwd_dq(q, k, v, out, lse, g, causal)
    rtol, atol = tfa.kernel_tolerance(dt, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_kernel_tolerance_fp32_is_the_jax_tolerance():
    """fp32: the JAX tolerance; bf16/fp16: two output roundings, and
    1e-3 plus one unit roundoff of the largest entry."""
    assert tfa.kernel_tolerance(torch.float32, torch.ones(3)) == (RTOL, ATOL)
    rtol, atol = tfa.kernel_tolerance(torch.bfloat16, torch.full((3,), 2.0))
    assert rtol == 2.0 ** -7 and atol == pytest.approx(2 * (1e-3 + 2 ** -8))
    rtol, atol = tfa.kernel_tolerance(torch.float16, torch.full((3,), 2.0))
    assert rtol == 2.0 ** -10 and atol == pytest.approx(2 * (1e-3 + 2 ** -11))


def test_kernel_tolerance_floor_is_a_floor():
    """bf16/fp16: atol is the larger of the want-scaled term and `floor`
    (zero where want is zero, so there the floor alone); fp32 keeps the
    JAX tolerance whatever the floor."""
    zero = torch.zeros(3)
    assert tfa.kernel_tolerance(torch.bfloat16, zero) == (2.0 ** -7, 0.0)
    assert tfa.kernel_tolerance(torch.bfloat16, zero, 1e-4) == \
        (2.0 ** -7, 1e-4)
    two = torch.full((3,), 2.0)
    assert tfa.kernel_tolerance(torch.float16, two, 1e-9) == \
        tfa.kernel_tolerance(torch.float16, two)
    assert tfa.kernel_tolerance(torch.float32, zero, 1.0) == (RTOL, ATOL)


@pytest.mark.parametrize("tq", [1, 40])
def test_backward_atol_floor_covers_the_noise_over_one_key(tq):
    """Over one key dQ and dK are exactly zero; a second fp32 summation
    order of dP = dO . v (sequential, from the last head-dim entry: as a
    kernel may sum) against the plain version's leaves noise within
    backward_atol_floor, summed over `tq` queries for dK."""
    q, k, v, g = (t.float() for t in _inputs16(24, (2, 16, tq, 64),
                                               (2, 16, 1, 64),
                                               torch.bfloat16))
    out, lse = tfa.flash_attention_reference(q, k, v, block_q=tq, block_k=1)
    want_dq, want_dk, _ = tfa.flash_attention_backward_reference(
        q, k, v, out, lse, g, block_q=tq, block_k=1)
    scale = 64 ** -0.5
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse[..., None])
    dp = (g * v).flip(-1).cumsum(-1)[..., -1:]
    ds = p * (dp - (g * out).sum(-1, keepdim=True)) * scale
    floors = tfa.backward_atol_floor(q, k, v, g, lse)
    assert float(want_dq.abs().max()) > 0  # the plain version's noise
    assert float((torch.matmul(ds, k) - want_dq).abs().max()) <= floors[0]
    assert float((torch.matmul(ds.transpose(-1, -2), q) - want_dk)
                 .abs().max()) <= floors[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim,causal", [
    ("float32", 64, True), ("float32", 32, False), ("bfloat16", 64, True),
    ("float16", 128, True)])
def test_kernel_matches_plain_on_card(dtype, head_dim, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 4, 200, head_dim, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    before = tfa.LAUNCHES
    out, lse = tfa.flash_attention_forward(q, k, v, causal=causal,
                                           block_q=200, block_k=200)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == before + 1
    want, want_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                   block_q=200, block_k=200)
    rtol, atol = tfa.kernel_tolerance(dt, want)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    # A CUDA tensor under grad goes to the backward kernels, not to an
    # error and not to the plain version.
    dkv0, dq0 = tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ
    qg = q.detach().requires_grad_()
    tfa.flash_attention(qg, k, v, causal=causal, block_q=200,
                        block_k=200).float().sum().backward()
    torch.cuda.synchronize()
    assert qg.grad is not None and qg.grad.dtype == dt
    assert (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == (dkv0 + 1, dq0 + 1)


# bf16/fp16 shapes for the tensor-core kernels (K1, K2, K3): ragged T (200,
# 1000: no multiple of a 64- or 128-row tile), Tq 256 against Tk 512,
# head dim 32 (64-byte swizzle), 64 and 128 (two 64-column panels), and
# non-causal T 2048, where P's rounding shows most.
CARD_16BIT_SHAPES = [
    ((2, 3, 200, 64), (2, 3, 200, 64), True),
    ((1, 4, 1000, 128), (1, 4, 1000, 128), False),
    ((1, 4, 1000, 64), (1, 4, 1000, 64), True),
    ((1, 4, 256, 64), (1, 4, 512, 64), True),
    ((1, 4, 256, 128), (1, 4, 512, 128), False),
    ((2, 3, 200, 32), (2, 3, 200, 32), True),
    ((1, 4, 1000, 32), (1, 4, 1000, 32), False),
    ((1, 4, 256, 32), (1, 4, 512, 32), True),
    ((1, 4, 2048, 64), (1, 4, 2048, 64), False),
]
CARD_16BIT_CASES = [(dt,) + case for dt in ("bfloat16", "float16")
                    for case in CARD_16BIT_SHAPES]
# The fp32 K1-K3 are split-TF32 wgmma kernels on the same tiles.
CARD_FP32_CASES = [("float32",) + case for case in CARD_16BIT_SHAPES]
# The fp32 K3's key tiles (32 keys, 16 at head dim 128) at their edges:
# Tk of 1, 16, 33 and 200 against another Tq, head dims 32 and 128,
# causal and not.
CARD_FP32_DQ_EDGES = [
    ("float32", (1, 2, 40, 32), (1, 2, 1, 32), False),
    ("float32", (1, 2, 40, 128), (1, 2, 1, 128), True),
    ("float32", (1, 3, 70, 32), (1, 3, 16, 32), True),
    ("float32", (1, 3, 70, 128), (1, 3, 16, 128), False),
    ("float32", (2, 2, 130, 32), (2, 2, 33, 32), False),
    ("float32", (2, 2, 130, 128), (2, 2, 33, 128), True),
    ("float32", (1, 2, 96, 32), (1, 2, 200, 32), True),
    ("float32", (1, 2, 96, 128), (1, 2, 200, 128), False),
]


# Every bf16/fp16 backward comparison the repo makes: the host emulations
# (EMULATED, T 1024), the card tests (CARD_16BIT_SHAPES and the two
# in test_backward_kernels_match_plain_on_card) and chip_smoke.py's.
FLOOR_SHAPES = sorted({((1, 2, 1024, d), (1, 2, 1024, d), causal)
                       for d in (64, 128) for causal in (False, True)} | {
    ((2, 4, 384, 64), (2, 4, 384, 64), True),
    ((2, 4, 384, 128), (2, 4, 384, 128), True),
} | set(CARD_16BIT_SHAPES) | set(chip_smoke.WGMMA_CASES))


def _largest_block(t, most=512):
    """The largest block <= `most` that divides `t` (the plain versions'
    contract)."""
    return max(b for b in range(1, min(t, most) + 1) if t % b == 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape_q,shape_k,causal", FLOOR_SHAPES)
def test_backward_atol_floor_lies_below_the_existing_atol(shape_q, shape_k,
                                                          causal, dtype):
    """At every shape of a bf16/fp16 backward comparison, standard normal
    inputs (as the card tests draw them), the floor from the inputs is
    below the atol that kernel_tolerance already gives dQ and dK there:
    passing it loosens no existing comparison."""
    dt = getattr(torch, dtype)
    q, k, v, g = _inputs16(23, shape_q, shape_k, dt)
    blocks = dict(block_q=_largest_block(shape_q[2]),
                  block_k=_largest_block(shape_k[2]))
    out, lse = tfa.flash_attention_reference(q, k, v, causal, **blocks)
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  causal, **blocks)
    floors = tfa.backward_atol_floor(q, k, v, g, lse, causal)
    for name, floor, w in zip(("dq", "dk"), floors, want):
        atol = tfa.kernel_tolerance(dt, w)[1]
        assert floor < atol, "%s: floor %.3g, atol %.3g" % (name, floor,
                                                            atol)
    assert floors[2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape_q,shape_k,causal",
                         CARD_16BIT_CASES + CARD_FP32_CASES)
def test_wgmma_forward_matches_plain_on_card(dtype, shape_q, shape_k,
                                             causal):
    """K1's tensor-core kernels (bf16/fp16 wgmma + TMA, fp32 split
    TF32) against the fp32 plain forward at ragged and cross shapes,
    within kernel_tolerance; LSE to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in (shape_q, shape_k, shape_k))
    blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
    before = tfa.LAUNCHES
    out, lse = tfa.flash_attention_forward(q, k, v, causal=causal, **blocks)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == before + 1
    want, want_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                   **blocks)
    rtol, atol = tfa.kernel_tolerance(dt, want)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 2, 64, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_forward(q, q, q)
    q = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_attention_forward(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_forward(q, q, q)


# -- backward -----------------------------------------------------------------

def _jax_vjp(q, k, v, g, **kw):
    """(dq, dk, dv) of the JAX op in interpret mode."""
    import jax

    jnp, jfa = _jax()
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


BWD_CASES = {
    "self": ((2, 2, 64, 16), (2, 2, 64, 16), dict(block_q=16, block_k=16)),
    "cross": ((1, 2, 16, 8), (1, 2, 48, 8), dict(block_q=8, block_k=16)),
    "scale": ((1, 2, 32, 8), (1, 2, 32, 8),
              dict(block_q=16, block_k=8, scale=0.5)),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_reference_matches_jax_vjp(case, causal):
    """The plain backward (blockwise regeneration from the saved LSE)
    against jax.vjp of the Pallas op: causal and not, Tq != Tk, an
    explicit scale, blocks 8 and 16."""
    shape_q, shape_k, kw = BWD_CASES[case]
    q, k, v = _qkv(10, shape_q, shape_k)
    g = np.random.RandomState(11).randn(*shape_q).astype(np.float32)
    want = _jax_vjp(q, k, v, g, causal=causal, **kw)
    tq_, tk_, tv_ = _torch(q, k, v)
    out, lse = tfa.flash_attention_forward(tq_, tk_, tv_, causal=causal,
                                           **kw)
    got = tfa.flash_attention_backward_reference(
        tq_, tk_, tv_, out, lse, torch.from_numpy(g), causal=causal, **kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg="d" + name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_autograd_function_matches_jax_vjp(case, causal):
    """flash_attention() differentiated by torch.autograd on host
    tensors (the autograd.Function around the launchers)."""
    shape_q, shape_k, kw = BWD_CASES[case]
    q, k, v = _qkv(12, shape_q, shape_k)
    g = np.random.RandomState(13).randn(*shape_q).astype(np.float32)
    want = _jax_vjp(q, k, v, g, causal=causal, **kw)
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, **kw)
    out.backward(torch.from_numpy(g))
    for name, t, b in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg="d" + name)


@pytest.mark.parametrize("causal", [False, True])
def test_record_backward_through_nd_contrib_matches_jax(causal):
    """mx.autograd.record() + nd.contrib.flash_attention + backward()
    in both packages, on packed (strided) q, k, v slices, with a head
    gradient."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(14)
    x = rng.randn(2, 3, 2, 32, 8).astype(np.float32)
    w = rng.randn(2, 2, 32, 8).astype(np.float32)

    def run(pkg, ctx):
        packed = pkg.nd.array(x, ctx=ctx) if ctx else pkg.nd.array(x)
        packed.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.contrib.flash_attention(
                packed[:, 0], packed[:, 1], packed[:, 2], causal=causal,
                block_q=16, block_k=16)
            loss = (out * (pkg.nd.array(w, ctx=ctx) if ctx
                           else pkg.nd.array(w))).sum()
        loss.backward()
        return out.asnumpy(), packed.grad.asnumpy()

    want_out, want_grad = run(jmx, None)
    got_out, got_grad = run(mx, mx.cpu())
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL, atol=ATOL)


def test_plain_twins_of_k2_and_k3_give_the_full_backward():
    """The plain versions of K2 (dk, dv) and K3 (dq), which chip_smoke.py
    times beside each kernel, are the full plain backward's parts."""
    q, k, v = _torch(*_qkv(15, (1, 2, 32, 8), (1, 2, 32, 8)))
    g = torch.from_numpy(np.random.RandomState(16).randn(1, 2, 32, 8)
                         .astype(np.float32))
    out, lse = tfa.flash_attention_forward(q, k, v, causal=True)
    full = tfa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  causal=True)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(q, k, v, out, lse, g,
                                                   causal=True)
    dq = tfa.flash_attention_bwd_dq_reference(q, k, v, out, lse, g,
                                              causal=True)
    for got, want in zip((dq, dk, dv), full):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape_q,shape_k,causal", [
    ("float32", (1, 4, 512, 64), (1, 4, 512, 64), True),
    ("float32", (1, 4, 512, 64), (1, 4, 512, 64), False),
    ("float32", (1, 4, 256, 64), (1, 4, 512, 64), False),
    ("float32", (1, 4, 256, 64), (1, 4, 512, 64), True),
    ("float32", (2, 3, 200, 32), (2, 3, 200, 32), True),
    ("float32", (1, 4, 384, 128), (1, 4, 384, 128), True),
    ("float32", (1, 4, 128, 128), (1, 4, 384, 128), False),
    ("bfloat16", (2, 4, 384, 64), (2, 4, 384, 64), True),
    ("float16", (2, 4, 384, 128), (2, 4, 384, 128), True),
] + CARD_16BIT_CASES + CARD_FP32_CASES)
def test_backward_kernels_match_plain_on_card(dtype, shape_q, shape_k,
                                              causal):
    """K2 and K3, through the autograd.Function, against the plain
    backward on the same CUDA inputs, fp32 at head dims 32, 64 and 128,
    and fp32, bf16 and fp16 at the ragged and cross shapes, dq, dk and
    dv each to kernel_tolerance; one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in (shape_q, shape_k, shape_k))
    g = torch.randn(shape_q, generator=gen, device="cuda").to(dt)
    bq, bk = shape_q[2], shape_k[2]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
    out = tfa.flash_attention(*leaves, causal=causal, block_q=bq,
                              block_k=bk)
    out.backward(g.transpose(2, 3).contiguous().transpose(2, 3))
    torch.cuda.synchronize()
    assert (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == \
        (before[0] + 1, before[1] + 1)
    out2, lse = tfa.flash_attention_forward(q, k, v, causal=causal,
                                            block_q=bq, block_k=bk)
    want = tfa.flash_attention_backward_reference(
        q, k, v, out2, lse, g, causal=causal, block_q=bq, block_k=bk)
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == dt
        rtol, atol = tfa.kernel_tolerance(dt, w)
        torch.testing.assert_close(t.grad.float(), w.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape_q,shape_k,causal", CARD_FP32_DQ_EDGES)
def test_fp32_dq_kernel_at_its_tile_edges_on_card(dtype, shape_q, shape_k,
                                                  causal):
    """The fp32 K3 at the edges of its key tiles (32 keys, 16 at head dim
    128): one launch of K2 and of K3, dQ and dV within
    kernel_tolerance(float32), and dK too where it is not exactly zero.
    Over one key (Tk 1) every dS is exactly zero, so dK = sum_i dS_i Q_i
    is, and both versions return rounding noise summed over the Tq
    queries, which the fixed fp32 atol does not cover (kernel_tolerance's
    floor is for bf16/fp16; ROADMAP.md Queue 3): there dK is held to the
    noise floor that backward_atol_floor derives from the inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in (shape_q, shape_k, shape_k))
    g = torch.randn(shape_q, generator=gen, device="cuda")
    blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
    tfa.flash_attention(*leaves, causal=causal, **blocks).backward(g)
    torch.cuda.synchronize()
    assert (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == \
        (before[0] + 1, before[1] + 1)
    out, lse = tfa.flash_attention_forward(q, k, v, causal=causal, **blocks)
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  causal=causal, **blocks)
    dk_floor = tfa.backward_atol_floor(q, k, v, g, lse, causal)[1]
    for name, t, w in zip("qkv", leaves, want):
        rtol, atol = tfa.kernel_tolerance(torch.float32, w)
        if name == "k" and shape_k[2] == 1:
            atol = dk_floor
        torch.testing.assert_close(t.grad, w, rtol=rtol, atol=atol,
                                   msg=lambda m: "d%s: %s" % (name, m))


@pytest.mark.cuda
def test_backward_over_one_key_meets_kernel_tolerance_on_card():
    """Attention over one key: P = 1, so dS = P (dP - delta) is exactly
    zero and so are dQ and dK; K2/K3 in bf16 and the plain version each
    give fp32 rounding noise there, where the want-scaled atol is zero.
    The floor from the inputs (backward_atol_floor) bounds that noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (2, 16, 1, 64)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention(*leaves, block_q=1, block_k=1).backward(g)
    torch.cuda.synchronize()
    out, lse = tfa.flash_attention_forward(q, k, v, block_q=1, block_k=1)
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  block_q=1, block_k=1)
    floors = tfa.backward_atol_floor(q, k, v, g, lse)
    for t, w, floor in zip(leaves, want, floors):
        rtol, atol = tfa.kernel_tolerance(torch.bfloat16, w, floor)
        torch.testing.assert_close(t.grad.float(), w.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
def test_record_backward_on_card_reaches_k2_and_k3():
    """mx.autograd.record() + nd.contrib.flash_attention + backward() on
    the card: one launch of each kernel, and the packed array's gradient
    agrees with the plain backward (fp32, the JAX tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(17)
    x = rng.randn(2, 3, 4, 256, 64).astype(np.float32)
    w = rng.randn(2, 4, 256, 64).astype(np.float32)
    packed = mx.nd.array(x, ctx=mx.gpu(0))
    packed.attach_grad()
    before = (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
    with mx.autograd.record():
        out = mx.nd.contrib.flash_attention(packed[:, 0], packed[:, 1],
                                            packed[:, 2], causal=True)
        loss = (out * mx.nd.array(w, ctx=mx.gpu(0))).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == \
        tuple(n + 1 for n in before)
    q, k, v = (torch.from_numpy(x[:, i]).cuda() for i in range(3))
    o, lse = tfa.flash_attention_forward(q, k, v, causal=True)
    want = tfa.flash_attention_backward_reference(
        q, k, v, o, lse, torch.from_numpy(w).cuda(), causal=True)
    got = packed.grad.data_
    for i in range(3):
        torch.testing.assert_close(got[:, i], want[i], rtol=RTOL, atol=ATOL)
