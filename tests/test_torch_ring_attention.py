"""Ring attention and blockwise attention against the JAX package's.

Counterparts of tests/test_ring_attention.py. The port's ring runs on 4
host ranks (gloo, ``parallel.launch``; tests/torch_dist_prog.py
``spmd_ring``) on ``{"dp": 2, "sp": 2}`` and ``{"sp": 4}`` meshes; the
JAX ``ring_self_attention`` runs on a mesh of the same shape over the
suite's virtual CPU devices. Forward outputs are held at
tests/test_ring_attention.py's rtol 2e-4 / atol 2e-5, and the gradients
of ``mean(out**2)`` with respect to q, k and v at its rtol 5e-4 /
atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import blockwise_attention as jblockwise
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import ring_self_attention as jring

from mxnet_tpu_torch.parallel import blockwise_attention

from torch_dist_prog import launch

torch.set_num_threads(2)

MESHES = {"dp2sp2": ({"dp": 2, "sp": 2}, (2, 2, 32, 8)),
          "sp4": ({"sp": 4}, (1, 2, 64, 8))}
_RUNS = {}


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _run(mesh_name, tmp_path_factory):
    if mesh_name not in _RUNS:
        axes, shape = MESHES[mesh_name]
        q, k, v = _qkv(shape, 0 if mesh_name == "dp2sp2" else 1)
        d = tmp_path_factory.mktemp(mesh_name)
        np.savez(d / "data.npz", q=q, k=k, v=v, mesh=mesh_name)
        launch(4, 0, "spmd_ring", d, data=d / "data.npz")
        _RUNS[mesh_name] = ((q, k, v), [dict(np.load(d / ("ring_r%d.npz"
                                                          % r)))
                                        for r in range(4)])
    return _RUNS[mesh_name]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ring_matches_jax_ring(mesh_name, causal, tmp_path_factory):
    (q, k, v), outs = _run(mesh_name, tmp_path_factory)
    axes, _ = MESHES[mesh_name]
    mesh = jmake_mesh(axes, devices=jax.devices()[:4])
    want = np.asarray(jax.jit(lambda a, b, c: jring(
        mesh, a, b, c, causal=causal))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    tag = "c" if causal else "n"
    for out in outs:
        np.testing.assert_allclose(out[tag + ":out"], want, rtol=2e-4,
                                   atol=2e-5)
        # Host tensors on a gloo group: nothing was staged.
        assert int(out["host_staged"]) == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ring_gradients_match_jax(mesh_name, causal, tmp_path_factory):
    (q, k, v), outs = _run(mesh_name, tmp_path_factory)
    axes, _ = MESHES[mesh_name]
    mesh = jmake_mesh(axes, devices=jax.devices()[:4])

    def loss(qq, kk, vv):
        return (jring(mesh, qq, kk, vv, causal=causal) ** 2).mean()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tag = "c" if causal else "n"
    for out in outs:
        for name, w in zip(("gq", "gk", "gv"), want):
            np.testing.assert_allclose(out["%s:%s" % (tag, name)],
                                       np.asarray(w), rtol=5e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    q, k, v = _qkv((2, 2, 64, 8), 2)
    want = np.asarray(jblockwise(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block=16, causal=causal))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block=16, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_blockwise_rejects_ragged_blocks():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 2, 30, 8), 3))
    with pytest.raises(ValueError, match="not divisible"):
        blockwise_attention(q, k, v, block=16)
