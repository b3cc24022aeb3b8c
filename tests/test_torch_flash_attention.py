"""mxnet_tpu_torch flash attention against the JAX package's Pallas op.

On the host the port runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_pallas_attention.py
runs it. Same numpy inputs, fp32, the JAX test's tolerance (rtol 2e-4,
atol 2e-5). The kernel itself is compared with the plain version on the
card by the `cuda`-marked tests, which skip here. This module imports
JAX only inside the tests that compare with it, so that the card tests
also run where JAX is not installed (see README.md).
"""
import numpy as np
import pytest
import torch

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
    tol = (RTOL, ATOL) if dt == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="K2"):
        tfa.flash_attention_forward(q.requires_grad_(), k, v,
                                    block_q=200, block_k=200)


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
