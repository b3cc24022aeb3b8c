"""mxnet_tpu_torch.module and model.FeedForward against the JAX
package's.

The single-device cases of tests/test_module.py: fit, score, predict and
checkpoint, BatchNorm aux, bucketing, fixed params, the optimizer-state
round trip, SequentialModule and FeedForward. Each runs the same numpy
weights and batches through the JAX Module (on the host) and the port's
Module (``mx.cpu()``), and compares after training; the tolerance is
stated per test (fp32: rtol 1e-5 of each tensor's entries plus an atol
of 1e-5 of its largest entry where a BatchNorm or a convolution sums in
another order). The symbols are built with ``mx.sym`` (the JAX package
cannot infer the aux shapes of a gluon export, ROADMAP Queue 3).

Then what the port adds or does differently: ``Module.load`` followed by
``fit(begin_epoch=)`` resumes bit for bit, multi-context and dist
stores raise, the executor frees the previous forward's graph, and the
``train_mnist`` example trains.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

torch.set_num_threads(2)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _ctx(pkg):
    return pkg.cpu()


def _mlp(pkg, hidden=16, classes=2):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _lenet_bn(pkg):
    """train_mnist's LeNet, narrowed, with a BatchNorm after the first
    convolution."""
    data = pkg.sym.Variable("data")
    c1 = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4, name="c1")
    bn = pkg.sym.BatchNorm(c1, fix_gamma=False, name="bn1")
    a1 = pkg.sym.Activation(bn, act_type="tanh", name="a1")
    p1 = pkg.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                         name="p1")
    f1 = pkg.sym.FullyConnected(p1, num_hidden=8, name="f1")
    a2 = pkg.sym.Activation(f1, act_type="tanh", name="a2")
    f2 = pkg.sym.FullyConnected(a2, num_hidden=3, name="f2")
    return pkg.sym.SoftmaxOutput(f2, name="softmax")


def _weights(sym, data_shape, seed=0, scale=0.3):
    """Numpy values for every parameter and aux state of `sym` (shapes
    from the port's inference)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args, auxs = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            args[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            args[name] = (rng.randn(*shape) * scale).astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        auxs[name] = (rng.uniform(0.5, 1.5, shape) if name.endswith("var")
                      else rng.randn(*shape) * 0.1).astype(np.float32)
    return args, auxs


def _nd(pkg, values):
    return {k: pkg.nd.array(v, ctx=_ctx(pkg)) for k, v in values.items()}


def _toy_data(n=40, d=6, classes=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    Y = rng.randint(0, classes, n).astype(np.float32)
    return X, Y


def _iter(pkg, X, Y, batch, **kw):
    if pkg is mx:
        kw["ctx"] = mx.cpu()
    return pkg.io.NDArrayIter(X, Y, batch_size=batch, **kw)


def _module(pkg, sym, **kw):
    mod_cls = pkg.mod.Module if pkg is mx else \
        __import__("mxnet_tpu.module", fromlist=["Module"]).Module
    return mod_cls(sym, context=_ctx(pkg), **kw)


def _params_np(mod):
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _close(got, want, rtol=RTOL, atol_rel=0.0):
    assert set(got) == set(want)
    for k in want:
        atol = atol_rel * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


OPT = {"learning_rate": 0.5, "momentum": 0.9}


def _fit_both(build, data_shape, X, Y, batch, epochs=2, opt=None,
              **fit_kw):
    out = []
    args, auxs = _weights(build(mx), data_shape)
    for pkg in (jmx, mx):
        mod = _module(pkg, build(pkg))
        it = _iter(pkg, X, Y, batch)
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params=dict(opt or OPT),
                arg_params=_nd(pkg, args), aux_params=_nd(pkg, auxs),
                **fit_kw)
        out.append((mod, it))
    return out


def test_module_fit_matches_jax():
    """Two epochs of Module.fit, SGD with momentum: every weight within
    rtol 1e-5 + 1e-5 of its tensor's largest entry (the bias of a unit
    whose value crosses zero rounds apart by an ulp of the sum)."""
    X, Y = _toy_data()
    (jm, _), (pm, _) = _fit_both(_mlp, (8, 6), X, Y, 8)
    _close(_params_np(pm)[0], _params_np(jm)[0], atol_rel=1e-5)


def test_module_score_and_predict_match_jax():
    X, Y = _toy_data(n=50)
    (jm, jit), (pm, pit) = _fit_both(_mlp, (10, 6), X, Y, 10, epochs=1)
    assert pm.score(pit, "acc") == jm.score(jit, "acc")
    pit.reset()
    jit.reset()
    jp, pp = jm.predict(jit), pm.predict(pit)
    assert pp.shape == (50, 2)
    np.testing.assert_allclose(pp.asnumpy(), jp.asnumpy(), rtol=RTOL,
                               atol=1e-6)
    pit.reset()
    outs = pm.predict(pit, merge_batches=False)
    assert len(outs) == 5 and outs[0][0].shape == (10, 2)


def test_module_batchnorm_aux_matches_jax():
    """LeNet with a BatchNorm, three steps: weights and the moving
    statistics within rtol 1e-5 + 1e-5 of each tensor's largest entry
    (the convolution and the batch statistics sum in another order)."""
    rng = np.random.RandomState(1)
    X = rng.rand(12, 1, 10, 10).astype(np.float32)
    Y = rng.randint(0, 3, 12).astype(np.float32)
    (jm, _), (pm, _) = _fit_both(_lenet_bn, (4, 1, 10, 10), X, Y, 4,
                                 epochs=1,
                                 opt={"learning_rate": 0.1,
                                      "momentum": 0.9})
    (pa, px), (ja, jx) = _params_np(pm), _params_np(jm)
    assert set(px) == {"bn1_moving_mean", "bn1_moving_var"}
    _close(pa, ja, atol_rel=1e-5)
    _close(px, jx, atol_rel=1e-5)
    assert np.abs(px["bn1_moving_mean"]).sum() > 0


def test_module_input_grads_match_jax():
    """inputs_need_grad: the data gradient of one backward, rtol 1e-5."""
    X, Y = _toy_data(n=8)
    args, _ = _weights(_mlp(mx), (8, 6))
    grads = []
    for pkg in (jmx, mx):
        mod = _module(pkg, _mlp(pkg))
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params=_nd(pkg, args))
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X, ctx=_ctx(pkg))],
                                 label=[pkg.nd.array(Y, ctx=_ctx(pkg))])
        mod.forward(batch, is_train=True)
        mod.backward()
        grads.append(mod.get_input_grads()[0].asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=1e-7)


def test_module_predict_and_checkpoint(tmp_path):
    X, Y = _toy_data(50, d=10)
    it = _iter(mx, X, Y, 10)
    mod = _module(mx, _mlp(mx, hidden=32))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    preds = mod.predict(it)
    assert preds.shape == (50, 2)
    prefix = str(tmp_path / "model")
    mod.save_checkpoint(prefix, 1)
    sym2, arg2, aux2 = mx.model.load_checkpoint(prefix, 1, ctx=mx.cpu())
    assert sym2.list_arguments() == mod.symbol.list_arguments()
    mod2 = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_params_from_preload()
    it.reset()
    np.testing.assert_array_equal(preds.asnumpy(), mod2.predict(it).asnumpy())


def test_module_checkpoint_files_cross_packages(tmp_path):
    """A JAX Module's save_checkpoint (params and .states) resumes in the
    port's Module: one more step equals the JAX step within rtol 1e-5."""
    X, Y = _toy_data(n=16)
    args, _ = _weights(_mlp(mx), (8, 6))
    batches = [(X[i:i + 8], Y[i:i + 8]) for i in (0, 8)]

    def step(pkg, mod, xy):
        b = pkg.io.DataBatch(data=[pkg.nd.array(xy[0], ctx=_ctx(pkg))],
                             label=[pkg.nd.array(xy[1], ctx=_ctx(pkg))])
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()

    jm = _module(jmx, _mlp(jmx))
    jm.bind(data_shapes=[("data", (8, 6))],
            label_shapes=[("softmax_label", (8,))])
    jm.init_params(arg_params=_nd(jmx, args))
    jm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    step(jmx, jm, batches[0])
    prefix = str(tmp_path / "jx")
    jm.save_checkpoint(prefix, 1, save_optimizer_states=True)
    pm = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                            context=mx.cpu())
    pm.bind(data_shapes=[("data", (8, 6))],
            label_shapes=[("softmax_label", (8,))])
    pm.init_params()
    pm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    step(jmx, jm, batches[1])
    step(mx, pm, batches[1])
    _close(_params_np(pm)[0], _params_np(jm)[0])


def test_bucketing_module_matches_jax():
    """Buckets 10, 5, 10 sharing one weight set (mean over the variable
    axis, then a dense layer): weights within rtol 1e-5."""
    from mxnet_tpu.module import BucketingModule as JBucketing

    def sym_gen(pkg):
        def gen(seq_len):
            data = pkg.sym.Variable("data")
            pooled = pkg.sym.mean(data, axis=1, keepdims=True)
            fc = pkg.sym.FullyConnected(pooled, num_hidden=2, name="fc")
            return pkg.sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
                ("softmax_label",)
        return gen

    rng = np.random.RandomState(3)
    w = {"fc_weight": rng.randn(2, 1).astype(np.float32),
         "fc_bias": rng.randn(2).astype(np.float32)}
    results = []
    for pkg, cls in ((jmx, JBucketing), (mx, mx.mod.BucketingModule)):
        mod = cls(sym_gen(pkg), default_bucket_key=10, context=_ctx(pkg))
        desc = pkg.io.DataDesc
        mod.bind(data_shapes=[desc("data", (4, 10))],
                 label_shapes=[desc("softmax_label", (4,))])
        mod.init_params(arg_params=_nd(pkg, w))
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        for key in (10, 5, 10):
            x = np.random.RandomState(key).rand(4, key).astype(np.float32)
            batch = pkg.io.DataBatch(
                data=[pkg.nd.array(x, ctx=_ctx(pkg))],
                label=[pkg.nd.array(np.array([0, 1, 1, 0], np.float32),
                                    ctx=_ctx(pkg))],
                bucket_key=key,
                provide_data=[desc("data", (4, key))],
                provide_label=[desc("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        assert set(mod._buckets) == {10, 5}
        results.append(_params_np(mod)[0])
    _close(results[1], results[0])


def test_module_fixed_params_match_jax():
    """fixed_param_names: the frozen layer keeps its values, the rest
    trains as in the JAX Module (rtol 1e-5)."""
    X, Y = _toy_data(n=16)
    args, _ = _weights(_mlp(mx), (16, 6))
    out = []
    for pkg in (jmx, mx):
        mod = _module(pkg, _mlp(pkg),
                      fixed_param_names=["fc1_weight", "fc1_bias"])
        mod.bind(data_shapes=[("data", (16, 6))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params=_nd(pkg, args))
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X, ctx=_ctx(pkg))],
                                 label=[pkg.nd.array(Y, ctx=_ctx(pkg))])
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        out.append(_params_np(mod)[0])
    np.testing.assert_array_equal(out[1]["fc1_weight"], args["fc1_weight"])
    assert not np.array_equal(out[1]["fc2_weight"], args["fc2_weight"])
    _close(out[1], out[0])


def test_module_optimizer_states_roundtrip(tmp_path):
    """save_checkpoint(save_optimizer_states=True) → Module.load +
    load_optimizer_states: momentum restored exactly; one more step
    equal bit for bit."""
    X, Y = _toy_data(n=40, d=10, seed=3)

    def one_step(mod, seed):
        r = np.random.RandomState(seed)
        idx = r.randint(0, len(X), 20)
        batch = mx.io.DataBatch(data=[mx.nd.array(X[idx])],
                                label=[mx.nd.array(Y[idx])])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    mod = _module(mx, _mlp(mx, hidden=32))
    mod.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))])
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    for s in range(3):
        one_step(mod, 100 + s)
    prefix = str(tmp_path / "opt_ckpt")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0003.states")
    mod2 = mx.mod.Module.load(prefix, 3, context=mx.cpu())
    mod2.bind(data_shapes=[("data", (20, 10))],
              label_shapes=[("softmax_label", (20,))])
    mod2.init_params_from_preload()
    mod2.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    mod2.load_optimizer_states("%s-%04d.states" % (prefix, 3))

    def flat(state):
        if isinstance(state, (list, tuple)):
            return [t for x in state for t in flat(x)]
        return [state] if state is not None else []

    s1, s2 = mod._updater.states, mod2._updater.states
    assert set(s1) == set(s2)
    for k in s1:
        for a, b in zip(flat(s1[k]), flat(s2[k])):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    one_step(mod, 777)
    one_step(mod2, 777)
    a1, a2 = _params_np(mod)[0], _params_np(mod2)[0]
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k])


def test_module_load_then_fit_resumes_bit_exact(tmp_path):
    """The ResNet resume of chip_smoke phase 15 at toy size:
    save_checkpoint(save_optimizer_states=True) after epoch 1, then
    Module.load(load_optimizer_states=True) and fit(begin_epoch=1)
    equal the uninterrupted two epochs bit for bit (BatchNorm aux
    included)."""
    rng = np.random.RandomState(1)
    X = rng.rand(12, 1, 10, 10).astype(np.float32)
    Y = rng.randint(0, 3, 12).astype(np.float32)
    args, auxs = _weights(_lenet_bn(mx), (4, 1, 10, 10))
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}

    def fit(mod, begin, end, **kw):
        mod.fit(_iter(mx, X, Y, 4), begin_epoch=begin, num_epoch=end,
                optimizer="sgd", optimizer_params=dict(opt), **kw)

    ref = _module(mx, _lenet_bn(mx))
    fit(ref, 0, 2, arg_params=_nd(mx, args), aux_params=_nd(mx, auxs))
    first = _module(mx, _lenet_bn(mx))
    prefix = str(tmp_path / "res")
    fit(first, 0, 1, arg_params=_nd(mx, args), aux_params=_nd(mx, auxs),
        epoch_end_callback=mx.callback.module_checkpoint(
            first, prefix, save_optimizer_states=True))
    resumed = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mx.cpu())
    fit(resumed, 1, 2)
    (ra, rx), (ga, gx) = _params_np(ref), _params_np(resumed)
    for k in ra:
        np.testing.assert_array_equal(ga[k], ra[k], err_msg=k)
    for k in rx:
        np.testing.assert_array_equal(gx[k], rx[k], err_msg=k)


def test_sequential_module_matches_jax():
    """Two modules chained (the second takes the labels) train as one
    Module of the composed graph: within rtol 1e-5 + 1e-5 of each
    tensor's largest entry of the JAX Module's weights after two steps.
    (The JAX package's SequentialModule itself cannot bind: it runs a
    forward before any parameter exists, ROADMAP Queue 3.)"""
    def parts():
        d1 = mx.sym.Variable("data")
        m1 = mx.sym.Activation(mx.sym.FullyConnected(
            d1, num_hidden=16, name="fc1"), act_type="relu")
        d2 = mx.sym.Variable("data")
        m2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            d2, num_hidden=2, name="fc2"), name="softmax")
        return m1, m2

    X, Y = _toy_data(n=8)
    args, _ = _weights(_mlp(mx), (8, 6))
    s1, s2 = parts()
    seq = mx.mod.SequentialModule()
    seq.add(_module(mx, s1, label_names=None))
    seq.add(_module(mx, s2), take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    assert seq.output_shapes == [("softmax_output", (8, 2))]
    seq.init_params(arg_params=_nd(mx, args))
    seq.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    jm = _module(jmx, _mlp(jmx))
    jm.bind(data_shapes=[("data", (8, 6))],
            label_shapes=[("softmax_label", (8,))])
    jm.init_params(arg_params=_nd(jmx, args))
    jm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    for pkg, mod in ((mx, seq), (jmx, jm)):
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X, ctx=_ctx(pkg))],
                                 label=[pkg.nd.array(Y, ctx=_ctx(pkg))])
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
    _close(_params_np(seq)[0], _params_np(jm)[0], atol_rel=1e-5)
    np.testing.assert_allclose(seq.get_outputs()[0].asnumpy(),
                               jm.get_outputs()[0].asnumpy(), rtol=RTOL,
                               atol=1e-6)


def test_feedforward_matches_jax(tmp_path):
    """The legacy FeedForward API: fit, predict and score as the JAX
    package's (rtol 1e-5), then save/load keeps the predictions."""
    X, Y = _toy_data(n=32)
    args, _ = _weights(_mlp(mx), (8, 6))
    preds = []
    for pkg in (jmx, mx):
        ff = pkg.model.FeedForward(_mlp(pkg), ctx=_ctx(pkg), num_epoch=2,
                                   learning_rate=0.5, momentum=0.9,
                                   arg_params=_nd(pkg, args),
                                   aux_params={})
        ff.fit(_iter(pkg, X, Y, 8))
        preds.append((ff, ff.predict(_iter(pkg, X, None, 8))))
    (jff, jp), (pff, pp) = preds
    np.testing.assert_allclose(pp, jp, rtol=RTOL, atol=1e-6)
    assert pff.score(_iter(mx, X, Y, 8)) == jff.score(_iter(jmx, X, Y, 8))
    prefix = str(tmp_path / "ff")
    pff.save(prefix)
    loaded = mx.model.FeedForward.load(prefix, 2, ctx=mx.cpu())
    np.testing.assert_array_equal(loaded.predict(_iter(mx, X, None, 8)), pp)


def test_feedforward_create():
    X, Y = _toy_data(n=64, seed=4)
    Y = (X[:, 0] > 0).astype(np.float32)
    ff = mx.model.FeedForward.create(_mlp(mx), _iter(mx, X, Y, 16),
                                     ctx=mx.cpu(), num_epoch=15,
                                     learning_rate=0.5, momentum=0.9,
                                     initializer=mx.init.Xavier())
    assert ff.score(_iter(mx, X, Y, 16)) > 0.9


def test_module_reshape():
    X, Y = _toy_data(n=8)
    mod = _module(mx, _mlp(mx))
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(initializer=mx.init.Xavier())
    before = _params_np(mod)[0]
    mod.reshape(data_shapes=[("data", (4, 6))],
                label_shapes=[("softmax_label", (4,))])
    assert mod.data_shapes == [("data", (4, 6))]
    after = _params_np(mod)[0]
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(X[:4])],
                                label=[mx.nd.array(Y[:4])]), is_train=False)
    assert mod.get_outputs()[0].shape == (4, 2)


def test_module_over_contexts_and_dist_stores_raise():
    # Several contexts bind one executor each and update through a local
    # store (tests/test_torch_trainer_contexts.py holds the numbers);
    # one context with a local store creates none. group2ctx onto
    # another device still raises (item 7b, test_torch_executor.py).
    two = mx.mod.Module(_mlp(mx), context=[mx.cpu(0), mx.cpu(1)])
    two.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    two.init_params()
    two.init_optimizer(kvstore="local")
    assert len(two._execs) == 2 and two._update_on_kvstore
    assert two._kvstore.type == "local"
    mod = _module(mx, _mlp(mx))
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer(kvstore="local")
    assert mod._kvstore is None and not mod._update_on_kvstore


def test_executor_frees_the_previous_graph():
    """backward frees the recorded graph (its saved activations go as it
    walks back, as loss.backward() frees them), and forward drops a graph
    no backward used before it records the next: Module.fit calls
    forward/backward on one executor every batch. A second backward of
    one forward records the forward again and gives the same
    gradients."""
    import weakref

    ex = _mlp(mx).simple_bind(ctx=mx.cpu(), data=(8, 6))
    for a in ex.arg_arrays:
        a[:] = np.random.RandomState(0).rand(*a.shape).astype(np.float32)
    ex.forward(is_train=True)
    graph = weakref.ref(ex._recorded[1][0])
    ex.backward()
    assert ex._recorded is None and graph() is None
    first = {n: g.asnumpy() for n, g in ex.grad_dict.items()
             if g is not None}
    ex.backward()
    for n, g in first.items():
        np.testing.assert_array_equal(ex.grad_dict[n].asnumpy(), g)
    ex.forward(is_train=True)
    unused = weakref.ref(ex._recorded[1][0])
    seen = []
    real = ex._run

    def run(*args):
        seen.append(unused() is None)
        return real(*args)

    ex._run = run
    ex.forward(is_train=True)
    assert seen == [True]


def test_executor_frees_values_after_their_last_use():
    """A forward holds each intermediate value only until its last
    consumer has run: along a chain of eight ReLUs at most one earlier
    output is alive when the next op starts (Module.fit's peak memory at
    ResNet-50 b32 was 1.8x the Trainer's while the plan held every
    value to the end of the forward)."""
    import weakref

    y = mx.sym.Variable("data")
    for i in range(8):
        y = mx.sym.Activation(y, act_type="relu", name="r%d" % i)
    ex = y.simple_bind(ctx=mx.cpu(), grad_req="null", data=(4, 5))
    variables, steps, heads, n = ex._plan(False)
    made, alive = [], []

    def watch(fn):
        def run(*args, **kwargs):
            alive.append(sum(r() is not None for r in made))
            out = fn(*args, **kwargs)
            made.append(weakref.ref(out))
            return out
        return run

    ex._plans[False] = (variables, [(watch(st[0]),) + st[1:]
                                    for st in steps], heads, n)
    out = ex.forward(is_train=False, data=-np.ones((4, 5), np.float32))
    assert alive == [0] + [1] * 7
    np.testing.assert_array_equal(out[0].asnumpy(), np.zeros((4, 5)))


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_train_mnist_example(network):
    from mxnet_tpu_torch.examples import train_mnist

    acc = train_mnist.main(["--synthetic", "--cpu", "--network", network,
                            "--num-epochs", "1", "--num-examples", "640",
                            "--batch-size", "32", "--lr", "0.1"])
    assert acc > 0.5


@pytest.mark.cuda
def test_module_fit_on_card_matches_host():
    """Module.fit of LeNet-BN on gpu(0) equals the host's within rtol 1e-5
    + 1e-5 of each tensor's largest entry (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    X = rng.rand(12, 1, 10, 10).astype(np.float32)
    Y = rng.randint(0, 3, 12).astype(np.float32)
    args, auxs = _weights(_lenet_bn(mx), (4, 1, 10, 10))
    out = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            mod = mx.mod.Module(_lenet_bn(mx), context=ctx)
            mod.fit(mx.io.NDArrayIter(X, Y, batch_size=4, ctx=ctx),
                    num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in args.items()},
                    aux_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in auxs.items()})
            out.append(_params_np(mod))
    _close(out[1][0], out[0][0], atol_rel=1e-5)
    _close(out[1][1], out[0][1], atol_rel=1e-5)


def test_float64_module_step_matches_float64_train_step():
    """A float64 data desc binds a float64 graph: one SGD step of the
    Module equals TrainStep(dtype="float64") on the same weights to
    fp32 rounding (the TrainStep keeps fp32 masters): weights within
    2^-22 relative + 1e-5 of the largest update, momentum within 1e-5 of
    each tensor's largest entry (chip_smoke phase 15's terms)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    X, Y = _toy_data(n=8)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    net = gluon.nn.HybridSequential(prefix="f64_")
    net.add(gluon.nn.Dense(16, activation="relu", in_units=6,
                           prefix="fc1_"))
    net.add(gluon.nn.Dense(2, in_units=16, prefix="fc2_"))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    w0 = {p.name: p.data().asnumpy().astype(np.float64)
          for p in net.collect_params().values()}
    ts = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                   dict(opt), mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]),
                   dtype="float64")
    ts(X, Y)
    params, states, _ = ts.state_to_host()
    sym = net(mx.sym.var("data"))
    sym = mx.sym.SoftmaxOutput(sym, name="softmax")
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[DataDesc("data", X.shape, np.float64)],
             label_shapes=[DataDesc("softmax_label", Y.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in w0.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    mod.forward(DataBatch(data=[mx.nd.array(X, dtype="float64")],
                          label=[mx.nd.array(Y)]), is_train=True)
    mod.backward()
    mod.update()
    got = _params_np(mod)[0]
    assert all(v.dtype == np.float64 for v in got.values())
    for n, w in got.items():
        step = float(np.abs(w - w0[n]).max())
        excess = float((np.abs(params[n] - w) - 2.0 ** -22 * np.abs(w))
                       .max())
        assert excess <= 1e-5 * step, n
        mom = mod._updater.states[mod._param_names.index(n)].asnumpy()
        assert np.abs(states[n][0] - mom).max() <= \
            1e-5 * np.abs(mom).max(), n
