"""mxnet_tpu_torch losses and optimizer update ops against the JAX
package's.

Losses: the per-sample values and the gradient with respect to `pred`
(the JAX side by `jax.vjp` of the loss block's forward, the port's by
`autograd.record()`/`backward()`), on the same numpy inputs. Update ops:
the registered FCompute of each package on the same numpy weights,
gradients and states. fp32; rtol 1e-6 / atol 1e-6 for the update ops
(a few elementwise roundings) and rtol 1e-5 / atol 1e-6 for the losses
(softmax and mean reductions, summed in other orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)


def _loss_pair(name, **kw):
    return (getattr(jmx.gluon.loss, name)(**kw),
            getattr(mx.gluon.loss, name)(**kw))


def _jax_value_and_grad(block, pred, label, weight=None):
    from mxnet_tpu.ndarray.ndarray import NDArray as JND

    def f(p):
        args = [JND(p), JND(jnp.asarray(label))]
        if weight is not None:
            args.append(JND(jnp.asarray(weight)))
        return block(*args)._data

    out, vjp = jax.vjp(f, jnp.asarray(pred))
    return np.asarray(out), np.asarray(vjp(jnp.ones_like(out))[0])


def _port_value_and_grad(block, pred, label, weight=None):
    with mx.cpu():
        p = mx.nd.array(pred)
        p.attach_grad()
        args = [mx.nd.array(label)]
        if weight is not None:
            args.append(mx.nd.array(weight))
        with mx.autograd.record():
            out = block(p, *args)
        out.backward()
    return out.asnumpy(), p.grad.asnumpy()


LOSSES = {
    "l2": ("L2Loss", {}, lambda r: r.randn(4, 3, 5).astype(np.float32)),
    "l2_weighted": ("L2Loss", {"weight": 0.3},
                    lambda r: r.randn(4, 6).astype(np.float32)),
    "l1": ("L1Loss", {}, lambda r: r.randn(4, 3, 5).astype(np.float32)),
    "ce_sparse": ("SoftmaxCrossEntropyLoss", {},
                  lambda r: r.randint(0, 7, 4).astype(np.float32)),
    "ce_sparse_clip": ("SoftmaxCrossEntropyLoss", {},
                       lambda r: np.array([0, 6, 9, -2], np.float32)),
    "ce_dense": ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
                 lambda r: r.dirichlet(np.ones(7), 4).astype(np.float32)),
    "ce_from_logits": ("SoftmaxCELoss", {"from_logits": True},
                       lambda r: r.randint(0, 7, 4).astype(np.float32)),
    "ce_axis1": ("SoftmaxCrossEntropyLoss", {"axis": 1},
                 lambda r: r.randint(0, 7, (4, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(case):
    name, kw, make_label = LOSSES[case]
    rng = np.random.RandomState(0)
    label = make_label(rng)
    if name == "SoftmaxCELoss" or case.startswith("ce"):
        shape = (4, 7, 3) if case == "ce_axis1" else (4, 7)
        pred = rng.randn(*shape).astype(np.float32)
        if kw.get("from_logits"):
            pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    else:
        pred = rng.randn(*label.shape).astype(np.float32)
    jblock, tblock = _loss_pair(name, **kw)
    want, want_g = _jax_value_and_grad(jblock, pred, label)
    got, got_g = _port_value_and_grad(tblock, pred, label)
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)


def test_sample_weight_matches_jax():
    rng = np.random.RandomState(1)
    pred = rng.randn(4, 5).astype(np.float32)
    label = rng.randn(4, 5).astype(np.float32)
    weight = rng.rand(4, 1).astype(np.float32)
    jblock, tblock = _loss_pair("L1Loss")
    want, want_g = _jax_value_and_grad(jblock, pred, label, weight)
    got, got_g = _port_value_and_grad(tblock, pred, label, weight)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_pick_matches_jax(axis, keepdims):
    rng = np.random.RandomState(2)
    a = rng.randn(3, 5, 4).astype(np.float32)
    shape = list(a.shape)
    del shape[axis]
    idx = rng.randint(-2, a.shape[axis] + 2, shape).astype(np.float32)
    want = jreg.get("pick").fn(jnp.asarray(a), jnp.asarray(idx), axis=axis,
                               keepdims=keepdims)
    got = treg.get("pick").fn(torch.from_numpy(a), torch.from_numpy(idx),
                              axis=axis, keepdims=keepdims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["square", "abs", "sqrt", "exp", "log"])
def test_unary_ops_match_jax(name):
    a = np.random.RandomState(3).rand(3, 4).astype(np.float32) + 0.1
    want = jreg.get(name).fn(jnp.asarray(a))
    got = treg.get(name).fn(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_mean_exclude_and_sum_keepdims_match_jax():
    a = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)
    for name, attrs in (("mean", dict(axis=0, exclude=True)),
                        ("mean", dict(axis=(0, 2), exclude=True)),
                        ("sum", dict(axis=-1, keepdims=True)),
                        ("broadcast_mul", None)):
        if attrs is None:
            b = np.random.RandomState(5).randn(2, 1, 4).astype(np.float32)
            want = jreg.get(name).fn(jnp.asarray(a), jnp.asarray(b))
            got = treg.get(name).fn(torch.from_numpy(a), torch.from_numpy(b))
        else:
            want = jreg.get(name).fn(jnp.asarray(a), **attrs)
            got = treg.get(name).fn(torch.from_numpy(a), **attrs)
        assert tuple(got.shape) == tuple(np.asarray(want).shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


UPDATES = {
    "sgd_update": (["weight", "grad"], {}),
    "sgd_mom_update": (["weight", "grad", "mom"], {"momentum": 0.9}),
    "mp_sgd_update": (["weight", "grad", "weight32"], {}),
    "mp_sgd_mom_update": (["weight", "grad", "mom", "weight32"],
                          {"momentum": 0.9}),
    "nag_mom_update": (["weight", "grad", "mom"], {"momentum": 0.9}),
}


@pytest.mark.parametrize("clip", [-1.0, 0.05])
@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_ops_match_jax(name, clip):
    names, attrs = UPDATES[name]
    rng = np.random.RandomState(6)
    arrays = [rng.randn(5, 3).astype(np.float32) for _ in names]
    attrs = dict(attrs, lr=0.1, wd=1e-2, rescale_grad=0.5,
                 clip_gradient=clip)
    want = jreg.get(name).fn(*[jnp.asarray(a) for a in arrays], **attrs)
    got = treg.get(name).fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_mp_update_returns_the_weight_in_its_dtype():
    """The mp forms update the fp32 master and hand the weight back in
    its own dtype (here bfloat16)."""
    rng = np.random.RandomState(7)
    w32 = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 4).astype(np.float32)).bfloat16()
    mom = torch.zeros(4, 4)
    w, new_mom, new_w32 = treg.get("mp_sgd_mom_update").fn(
        w32.bfloat16(), g, mom, w32, lr=0.1, momentum=0.9)
    assert w.dtype == torch.bfloat16
    assert new_mom.dtype == new_w32.dtype == torch.float32
    torch.testing.assert_close(w, new_w32.bfloat16())


def test_update_ops_are_not_recorded():
    """Update ops are registered non-differentiable: under record() they
    build no graph, as the reference never tapes them."""
    with mx.cpu():
        w = mx.nd.array(np.ones((3,), np.float32))
        w.attach_grad()
        with mx.autograd.record():
            new = mx.nd.sgd_update(w, mx.nd.array(np.ones((3,), np.float32)),
                                   lr=0.5)
    assert not new.data_.requires_grad
    np.testing.assert_allclose(new.asnumpy(), 0.5)
    assert treg.get("sgd_mom_update").differentiable is False
