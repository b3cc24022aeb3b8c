"""mxnet_tpu_torch ResNet against the JAX package's ResNet.

The JAX net is built and initialized, its BatchNorm moving stats, gamma
and beta are set to random non-trivial values, and all its weights are
carried to the port's net with `params_from_numpy`. Eval logits on the
same numpy batch must agree within rtol 1e-4 / atol 1e-5 * max|logit|
(fp32; the two frameworks sum convolutions in different orders, and
the error grows with depth), with the port hybridized and not.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

torch.set_num_threads(2)

CASES = {
    "resnet18_v1": (dict(classes=8, thumbnail=True), (2, 3, 32, 32)),
    "resnet50_v1": (dict(classes=10), (2, 3, 64, 64)),
    "resnet18_v2": (dict(classes=8, thumbnail=True), (2, 3, 32, 32)),
}
_REFS = {}


def _randomize_bn(net, rng):
    for name, p in net.collect_params().items():
        if name.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
        elif name.endswith("gamma"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))


def _reference(model):
    """(jax net prefix, {name: weights}, input, eval logits), once per
    model and worker."""
    if model not in _REFS:
        kwargs, shape = CASES[model]
        rng = np.random.RandomState(0)
        net = getattr(jvision, model)(**kwargs)
        net.initialize()
        x = rng.rand(*shape).astype(np.float32)
        with jmx.autograd.pause():
            net(jmx.nd.array(x))  # deferred shape inference
        _randomize_bn(net, rng)
        with jmx.autograd.pause():
            want = net(jmx.nd.array(x)).asnumpy()
        arrays = {n: p.data().asnumpy()
                  for n, p in net.collect_params().items()}
        _REFS[model] = (net.prefix, arrays, x, want)
    return _REFS[model]


def _port_net(model, prefix, arrays, **kwargs):
    with mx.cpu():
        net = getattr(vision, model)(**(kwargs or CASES[model][0]))
        net.initialize()
        params_from_numpy(net, arrays, prefix=prefix)
    return net


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("model", sorted(CASES))
def test_eval_logits_match_jax(model, hybridize):
    prefix, arrays, x, want = _reference(model)
    net = _port_net(model, prefix, arrays)
    if hybridize:
        net.hybridize()
    with mx.cpu(), mx.autograd.pause():
        got = net(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hybridize", [False, True])
def test_train_mode_forward_and_running_stats_match_jax(hybridize):
    """Train-mode BatchNorm: batch statistics in the output and the
    moving stats committed after the call (through the CachedOp's
    captured aux writes when hybridized)."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 3, 16, 16).astype(np.float32)
    jnet = jvision.resnet18_v1(classes=4, thumbnail=True)
    jnet.initialize()
    with jmx.autograd.pause():
        jnet(jmx.nd.array(x))
    _randomize_bn(jnet, rng)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = _port_net("resnet18_v1", jnet.prefix, arrays, classes=4,
                    thumbnail=True)
    jnet.hybridize(hybridize)
    net.hybridize(hybridize)
    with jmx.autograd.train_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu(), mx.autograd.train_mode():
        got = net(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    rel = relative_names(list(arrays), jnet.prefix)
    after = {rel[n]: p.data().asnumpy()
             for n, p in jnet.collect_params().items()}
    before = {rel[n]: v for n, v in arrays.items()}
    mine = relative_names(list(net.collect_params().keys()), net.prefix)
    checked = 0
    for name, p in net.collect_params().items():
        if name.endswith(("running_mean", "running_var")):
            got_stat = p.data().asnumpy()
            np.testing.assert_allclose(got_stat, after[mine[name]],
                                       rtol=1e-4, atol=1e-5)
            assert not np.allclose(got_stat, before[mine[name]])
            checked += 1
    assert checked == 2 * 19  # BatchNorm layers of thumbnail resnet18_v1


def test_num_traces_one_per_input_shape():
    prefix, arrays, x, _ = _reference("resnet18_v1")
    net = _port_net("resnet18_v1", prefix, arrays)
    net.hybridize()
    with mx.cpu(), mx.autograd.pause():
        for rows in (2, 1, 2, 1, 2):
            assert net(mx.nd.array(x[:rows])).shape == (rows, 8)
    assert net._cached_op.num_traces == 2


def test_parameter_names_follow_the_reference_scheme():
    """Counter-based names, as the JAX package gives them; relative
    names agree between the two packages."""
    jnet = jvision.resnet50_v1(classes=10)
    with mx.cpu():
        net = vision.resnet50_v1(classes=10)
    jn = list(jnet.collect_params().keys())
    tn = list(net.collect_params().keys())
    assert len(jn) == len(tn)
    assert sorted(relative_names(jn, jnet.prefix).values()) == \
        sorted(relative_names(tn, net.prefix).values())
    assert all(n.split("_")[0].rstrip("0123456789") in
               ("conv2d", "batchnorm", "dense") for n in tn)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_numpy_rejects_mismatch(fault):
    prefix, arrays, _, _ = _reference("resnet18_v1")
    arrays = dict(arrays)
    name = sorted(arrays)[0]
    if fault == "missing":
        del arrays[name]
    elif fault == "extra":
        arrays["dense999_weight"] = np.zeros((1, 1), np.float32)
    else:
        arrays[name] = np.zeros(arrays[name].shape + (1,), np.float32)
    with mx.cpu():
        net = vision.resnet18_v1(**CASES["resnet18_v1"][0])
        net.initialize()
        with pytest.raises(ValueError):
            params_from_numpy(net, arrays, prefix=prefix)


def test_get_model_builds_every_resnet_depth():
    with mx.cpu():
        for n in (18, 34, 50, 101, 152):
            for v in (1, 2):
                net = vision.get_model("resnet%d_v%d" % (n, v), classes=3)
                assert isinstance(net, mx.gluon.HybridBlock)
    with pytest.raises(ValueError):
        vision.get_model("alexnet")
