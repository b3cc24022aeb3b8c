"""Data parallelism over contexts in one process: Trainer and Module.

The port's Trainer over ``[cpu(0), cpu(1)]`` with
``gluon.utils.split_and_load`` against the JAX package's Trainer over
two of the suite's virtual CPU devices, and the port's Module over two
contexts against the JAX Module; the overlapped fused step's
invariants (the JAX package's verify flow "overlapped fused step"):
overlap depth 2 equals depth 0 bit for bit and ``fused=True`` equals
``fused=False``; the bucketed update-on-kvstore. fp32 state is held at
rtol 1e-5 and atol 1e-4 of each tensor's largest magnitude
(tests/test_torch_train_step.py's state tolerance).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.module import Module as JModule

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

torch.set_num_threads(2)

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, in_units=6, activation="tanh"))
    net.add(pkg.gluon.nn.Dense(3, in_units=16))
    return net


def _train(pkg, net, ctxs, batches, **trainer_kw):
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                           **trainer_kw)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in batches:
        xl = pkg.gluon.utils.split_and_load(pkg.nd.array(x, ctx=ctxs[0]),
                                            ctxs)
        yl = pkg.gluon.utils.split_and_load(pkg.nd.array(y, ctx=ctxs[0]),
                                            ctxs)
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xl, yl)]
        for l in losses:
            l.backward()
        tr.step(x.shape[0])
    return tr


def _state(net, ctx):
    params = net.collect_params()
    rel = relative_names(list(params.keys()), net.prefix)
    return {rel[k]: p.data(ctx).asnumpy() for k, p in params.items()}


def _batches(seed, n=3, batch=8):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 6).astype(np.float32),
             rng.randint(0, 3, batch).astype(np.float32)) for _ in range(n)]


def _hold(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_trainer_over_two_contexts_matches_jax(fused):
    jctx = [jmx.cpu(0), jmx.cpu(1)]
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jctx)
    arrays = {k: p.data(jctx[0]).asnumpy()
              for k, p in jnet.collect_params().items()}
    ctxs = [mx.cpu(0), mx.cpu(1)]
    with mx.cpu():
        net = _net(mx)
        net.initialize(ctx=ctxs)
    params_from_numpy(net, arrays, prefix=jnet.prefix)
    batches = _batches(0)
    _train(jmx, jnet, jctx, batches, fused=fused)
    tr = _train(mx, net, ctxs, batches, fused=fused)
    assert tr._kvstore is not None and not tr._update_on_kvstore
    want = _state(jnet, jctx[0])
    for c in ctxs:
        _hold(_state(net, c), want)


def _many_params(n=40, size=8192, seed=5):
    """Enough parameters for two 1 MB buckets."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(size).astype(np.float32) for _ in range(n)]
    ctxs = [mx.cpu(0), mx.cpu(1)]
    params = []
    for k, v in enumerate(vals):
        p = mx.gluon.Parameter("ovd_%d" % k, shape=(size,))
        p.initialize(init=mx.init.Constant(0.0), ctx=ctxs)
        p.set_data(v)
        params.append(p)
    return params


def _grad_steps(params, trainer, steps=3, seed=6):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        for p in params:
            for g in p.list_grad():
                g[:] = rng.randn(*p.shape).astype(np.float32)
        trainer.step(2)
    return [np.concatenate([p.data(c).asnumpy() for p in params])
            for c in (mx.cpu(0), mx.cpu(1))]


def test_overlap_depth_and_fused_leave_the_trajectory_bit_identical(
        monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_BUCKET_MB", "1")
    runs = {}
    for tag, depth, fused in (("depth2", "2", True), ("depth0", "0", True),
                              ("loop", "2", False)):
        monkeypatch.setenv("MXNET_FUSED_OVERLAP_DEPTH", depth)
        params = _many_params()
        tr = mx.gluon.Trainer(params, "sgd", dict(OPT), fused=fused)
        runs[tag] = _grad_steps(params, tr)
        if fused:
            assert len(tr._bucketer) == 2
    for tag in ("depth0", "loop"):
        for a, b in zip(runs["depth2"], runs[tag]):
            np.testing.assert_array_equal(a, b, err_msg=tag)
    # The two contexts hold the same weights.
    np.testing.assert_array_equal(runs["depth2"][0], runs["depth2"][1])


def test_bucketed_update_on_kvstore(monkeypatch):
    """update_on_kvstore=True over a local store: the store holds one
    flat weight vector per bucket and runs SGD on it; the weights equal
    the local update's."""
    monkeypatch.setenv("MXNET_FUSED_BUCKET_MB", "1")
    params = _many_params()
    tr = mx.gluon.Trainer(params, "sgd", dict(OPT), update_on_kvstore=True)
    got = _grad_steps(params, tr)
    assert tr._uokv_bucketed and tr._kvstore.type == "device"
    assert sum(1 for k in tr._kvstore._store
               if str(k).startswith("__fused_grad_bucket")) == 2
    params = _many_params()
    ref = mx.gluon.Trainer(params, "sgd", dict(OPT), update_on_kvstore=False)
    want = _grad_steps(params, ref)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0], got[1])


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def test_module_over_two_contexts_matches_jax():
    rng = np.random.RandomState(7)
    shapes = {"fc1_weight": (16, 6), "fc1_bias": (16,),
              "fc2_weight": (3, 16), "fc2_bias": (3,)}
    arg = {k: (rng.randn(*s) * 0.3).astype(np.float32)
           for k, s in shapes.items()}
    batches = _batches(8, n=2)
    results = []
    for pkg, ctxs in ((jmx, [jmx.cpu(0), jmx.cpu(1)]),
                      (mx, [mx.cpu(0), mx.cpu(1)])):
        cls = JModule if pkg is jmx else mx.mod.Module
        mod = cls(_mlp(pkg), context=ctxs)
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctxs[0])
                                    for k, v in arg.items()})
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=dict(OPT))
        for x, y in batches:
            batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctxs[0])],
                                     label=[pkg.nd.array(y, ctx=ctxs[0])])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        assert len(mod._execs) == 2 and mod._update_on_kvstore
        out = mod.get_outputs()[0].asnumpy()
        assert out.shape == (8, 3)
        results.append(({k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()}, out))
    (want, want_out), (got, got_out) = results
    _hold(got, want)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-6)
