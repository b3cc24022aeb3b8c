"""mxnet_tpu_torch autograd against the JAX package's tape.

The same numpy inputs and weights go through `mxnet_tpu.autograd` and
`mxnet_tpu_torch.autograd` (record/backward, grad, Function, grad_req
"write"/"add", pause, detach, mutation after recording) and through a
small Conv/BN/Dense net whose parameter gradients are compared. fp32;
rtol 1e-5 / atol 1e-6 (a few layers of sums in other orders).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _both(fn):
    """fn(pkg, array) run with each package; returns (jax, port)."""
    want = fn(jmx, jmx.nd.array)
    with mx.cpu():
        got = fn(mx, mx.nd.array)
    return want, got


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_simple_chain_head_grad_and_multiple_uses():
    def fn(pkg, arr):
        x = arr(np.array([[1.0, 2.0], [3.0, -4.0]], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.exp(x * 0.1).sum() + (x * x + x).sum()
        y.backward()
        g1 = x.grad.asnumpy()
        with pkg.autograd.record():
            z = 3 * x
        z.backward(arr(np.array([[10.0, 100.0], [1.0, 2.0]], np.float32)))
        return g1, x.grad.asnumpy()

    (w1, w2), (g1, g2) = _both(fn)
    _close(g1, w1)
    _close(g2, w2)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add(req):
    def fn(pkg, arr):
        x = arr(np.array([1.0, 2.0], np.float32))
        x.attach_grad(grad_req=req)
        for k in range(3):
            with pkg.autograd.record():
                y = ((k + 2) * x * x).sum()
            y.backward()
        return x.grad.asnumpy()

    want, got = _both(fn)
    _close(got, want)
    if req == "add":
        _close(got, [18.0, 36.0])


def test_autograd_grad_of_unmarked_and_intermediate_arrays():
    """grad() needs no attach_grad, reaches recorded intermediates, and
    leaves .grad buffers alone."""
    def fn(pkg, arr):
        x = arr(np.array([1.0, 2.0, 3.0], np.float32))
        w = arr(np.array([0.5, -1.0, 2.0], np.float32))
        w.attach_grad()
        with pkg.autograd.record():
            h = x * w
            y = (h * h).sum()
        gx, gh, gw = pkg.autograd.grad([y], [x, h, w], retain_graph=True)
        return gx.asnumpy(), gh.asnumpy(), gw.asnumpy(), w.grad.asnumpy()

    want, got = _both(fn)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[3], 0.0)


def test_grad_of_an_array_the_heads_do_not_use_is_zero():
    def fn(pkg, arr):
        x = arr(np.array([1.0, 2.0], np.float32))
        other = arr(np.array([5.0], np.float32))
        with pkg.autograd.record():
            y = (x * x).sum()
        return pkg.autograd.grad([y], [other])[0].asnumpy()

    want, got = _both(fn)
    _close(got, want)


def test_custom_function_matches_jax():
    def fn(pkg, arr):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1.0 / (1.0 + pkg.nd.exp(-x))
                self._saved = y
                return y

            def backward(self, dy):
                y = self._saved
                return dy * y * (1 - y)

        x = arr(np.array([0.0, 1.0, -2.0], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = Sigmoid()(x)
            z = (y * arr(np.array([1.0, 2.0, 3.0], np.float32))).sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()

    (wy, wg), (gy, gg) = _both(fn)
    _close(gy, wy)
    _close(gg, wg)


def test_pause_detach_and_mutation_after_recording():
    def fn(pkg, arr):
        x = arr(np.array([2.0], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x
            with pkg.autograd.pause():
                _ = y * 10  # not recorded
            z = y.detach() * x + y
        x += 100  # the tape keeps what it recorded
        z.backward()
        return x.grad.asnumpy()

    want, got = _both(fn)
    _close(got, want)
    _close(got, [8.0])  # d(4x + x^2)/dx at x = 2


def test_unrecorded_head_raises_and_create_graph_is_not_supported():
    with mx.cpu():
        with pytest.raises(ValueError, match="record"):
            mx.nd.array(np.ones(2, np.float32)).backward()
        x = mx.nd.array(np.ones(2, np.float32))
        with mx.autograd.record():
            y = (x * x).sum()
        with pytest.raises(NotImplementedError):
            mx.autograd.grad([y], [x], create_graph=True)
    with pytest.raises(ValueError):
        jmx.nd.array(np.ones(2, np.float32)).backward()


def test_ops_outside_record_build_no_graph():
    with mx.cpu():
        x = mx.nd.array(np.ones(3, np.float32))
        x.attach_grad()
        y = x * 2
        assert not y.data_.requires_grad
        with mx.autograd.record():
            with mx.autograd.pause():
                assert not (x * 2).data_.requires_grad
            assert (x * 2).data_.requires_grad
            assert mx.autograd.is_recording() and mx.autograd.is_training()
        with mx.autograd.record(train_mode=False):
            assert not mx.autograd.is_training()
        assert not mx.autograd.is_recording() and not mx.autograd.is_training()


def _small_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, in_channels=2))
    net.add(pkg.gluon.nn.BatchNorm(in_channels=4))
    net.add(pkg.gluon.nn.Activation("relu"))
    net.add(pkg.gluon.nn.Dense(3, in_units=4 * 5 * 5))
    return net


def _net_pair(seed):
    rng = np.random.RandomState(seed)
    jnet = _small_net(jmx)
    jnet.initialize()
    for name, p in jnet.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("beta", "running_mean", "bias")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with mx.cpu():
        net = _small_net(mx)
        net.initialize(ctx=mx.cpu())
        params_from_numpy(net, arrays, prefix=jnet.prefix)
    return jnet, net, rng.randn(3, 2, 5, 5).astype(np.float32)


def _grads(net):
    names = relative_names(list(net.collect_params().keys()), net.prefix)
    return {names[n]: p.grad().asnumpy()
            for n, p in net.collect_params().items() if p.grad_req != "null"}


@pytest.mark.parametrize("hybridize", [False, True])
def test_conv_bn_dense_parameter_gradients_match_jax(hybridize):
    """record()/backward() through Conv/BN(train mode)/ReLU/Dense: every
    parameter gradient, and the running stats the recorded forward
    committed, against the JAX package."""
    jnet, net, x = _net_pair(0)
    w = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    net.hybridize(hybridize)
    with jmx.autograd.record():
        jout = jnet(jmx.nd.array(x))
        jloss = (jout * jmx.nd.array(w)).sum()
    jloss.backward()
    with mx.cpu():
        with mx.autograd.record():
            out = net(mx.nd.array(x))
            loss = (out * mx.nd.array(w)).sum()
        loss.backward()
    _close(out.asnumpy(), jout.asnumpy())
    want, got = _grads(jnet), _grads(net)
    assert sorted(want) == sorted(got) and len(got) == 6
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    jstats = {relative_names([n], jnet.prefix)[n]: p.data().asnumpy()
              for n, p in jnet.collect_params().items()
              if n.endswith(("running_mean", "running_var"))}
    for n, p in net.collect_params().items():
        if n.endswith(("running_mean", "running_var")):
            rel = relative_names([n], net.prefix)[n]
            _close(p.data().asnumpy(), jstats[rel])
            assert not p.data().data_.requires_grad


def test_hybridized_net_under_record_gets_the_unhybridized_gradients():
    """The CachedOp repair: a hybridized call under record() keeps the
    graph (in train mode: BatchNorm batch statistics)."""
    _, a, x = _net_pair(2)
    with mx.cpu():
        b = _small_net(mx)
        b.initialize(ctx=mx.cpu())
        params_from_numpy(b, {n: p.data().asnumpy() for n, p in
                              a.collect_params().items()}, prefix=a.prefix)
    b.hybridize()
    results = []
    with mx.cpu():
        for net in (a, b):
            with mx.autograd.record():
                out = net(mx.nd.array(x))
                loss = (out * out).sum()
            loss.backward()
            results.append(_grads(net))
    assert b._cached_op is not None and b._cached_op.num_traces == 1
    for name in results[0]:
        np.testing.assert_allclose(results[1][name], results[0][name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        assert np.abs(results[0][name]).max() > 0


def test_parameter_grad_buffers():
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=mx.cpu())
        x = mx.nd.array(np.ones((4, 3), np.float32))
        with mx.autograd.record():
            y = net(x).sum()
        y.backward()
        np.testing.assert_allclose(net.weight.grad().asnumpy(), 4.0)
        assert net.weight.list_grad()[0] is net.weight.grad(mx.cpu())
        net.collect_params().zero_grad()
        np.testing.assert_allclose(net.weight.grad().asnumpy(), 0.0)
        net.bias.grad_req = "null"
        assert net.bias.list_grad() == []
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            net.bias.grad()
        with mx.autograd.record():
            y = net(x).sum()
        y.backward()
        np.testing.assert_allclose(net.weight.grad().asnumpy(), 4.0)
        net.bias.grad_req = "write"
        np.testing.assert_allclose(net.bias.grad().asnumpy(), 0.0)
        # running stats are "null" parameters: no buffer.
        bn = mx.gluon.nn.BatchNorm(in_channels=2)
        bn.initialize(ctx=mx.cpu())
        assert bn.running_mean.list_grad() == []
