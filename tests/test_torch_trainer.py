"""gluon.Trainer of mxnet_tpu_torch against the JAX package's, and the
port's fused multi-tensor apply against its own per-parameter loop.

Across packages the JAX Trainer runs ``fused=False`` (its per-parameter
loop; its fused NAG path is flaky under load, ROADMAP Queue 3) on the
same numpy weights and batches, on the host. A Dense-BN-Dense net is
compared tensor by tensor after three steps (rtol 1e-5, atol 1e-4 of
each tensor's largest entry: the forward, the BatchNorm statistics and
the backward round apart by a few ulps per step). A ResNet-18 thumbnail
is compared per step from a common state by relative L2 error over the
net, since its ReLU kinks flip between packages (ROADMAP Queue 3).

Inside the port, ``fused=True`` must equal ``fused=False`` bit for bit:
weights and every optimizer state, at vector-aligned and odd sizes,
fp32 and bf16 with fp32 masters, with lr/wd multipliers, the global-norm
clip, several chunks, and across save/load and set_data.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fused_update
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

torch.set_num_threads(2)


def _dense_bn_dense(pkg, hidden=8, n_in=4, n_out=3):
    """No bias before BatchNorm: its gradient is zero in exact arithmetic,
    and the scale-free families (AdaGrad, Adam, RMSProp, Signum) would
    step by the sign of each package's rounding noise there."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(hidden, in_units=n_in, use_bias=False))
    net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(n_out, in_units=hidden))
    return net


def _init(pkg, build, x_shape, seed, ctx=None):
    rng = np.random.RandomState(seed)
    net = build(pkg)
    if ctx is None:
        net.initialize()
        with pkg.autograd.pause():
            net(pkg.nd.array(rng.rand(*x_shape).astype(np.float32)))
    else:
        net.initialize(ctx=ctx)
        with ctx, pkg.autograd.pause():
            net(pkg.nd.array(rng.rand(*x_shape).astype(np.float32)))
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith("running_var") or name.endswith("gamma"):
            p.set_data(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "bias")):
            p.set_data(rng.uniform(-0.5, 0.5, shape).astype(np.float32))
    return net


def _pair(build, x_shape, seed):
    """(jax net, port net) with the same weights."""
    jnet = _init(jmx, build, x_shape, seed)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with mx.cpu():
        net = build(mx)
        net.initialize(ctx=mx.cpu())
        params_from_numpy(net, arrays, prefix=jnet.prefix)
    return jnet, net


def _batches(rng, n, x_shape, classes):
    return [(rng.rand(*x_shape).astype(np.float32) * 3 - 1,
             rng.randint(0, classes, x_shape[0]).astype(np.float32))
            for _ in range(n)]


def _train(pkg, net, trainer, batches, ctx=None, dtype=None, backwards=1):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        for _ in range(backwards):
            kw = {} if ctx is None else {"ctx": ctx}
            xx = pkg.nd.array(x, dtype=dtype, **kw)
            with pkg.autograd.record():
                out = net(xx)
                if dtype is not None:
                    out = out.astype("float32")
                loss = loss_fn(out, pkg.nd.array(y, **kw))
            loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy().mean()))
    return np.array(losses)


def _by_relative(net, values):
    rel = relative_names(list(values), net.prefix)
    return {rel[n]: v for n, v in values.items()}


def _params(net):
    return _by_relative(net, {n: p.data().asnumpy().astype(np.float32)
                              for n, p in net.collect_params().items()})


def _states(net, trainer):
    """{relative name: [state arrays]} of the trainer's updater."""
    names = [p.name for p in trainer._params]
    out = {}

    def flat(s):
        if s is None:
            return []
        if isinstance(s, (list, tuple)):
            return [x for y in s for x in flat(y)]
        return [np.asarray(s.asnumpy(), np.float32)]

    for i, s in trainer._updater.states.items():
        out[names[i]] = flat(s)
    return _by_relative(net, out)


FAMILIES = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
    "nag": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
    "adam": {"learning_rate": 0.01, "wd": 0.001},
    "rmsprop": {"learning_rate": 0.01, "centered": True},
    "adagrad": {"learning_rate": 0.05},
    "adadelta": {"wd": 0.01},
    "signum": {"learning_rate": 0.01, "wd_lh": 0.01},
    "ftml": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "ftrl": {"learning_rate": 0.1},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.9},
}


@pytest.mark.parametrize("optimizer", sorted(FAMILIES))
def test_dense_bn_dense_three_steps_match_jax_trainer(optimizer):
    """Losses, weights, optimizer states and BatchNorm running stats
    after three Trainer steps (the port fused where its family allows,
    the JAX Trainer per parameter)."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 0)
    batches = _batches(np.random.RandomState(1), 3, (8, 4), 3)
    opt = FAMILIES[optimizer]
    jtr = jmx.gluon.Trainer(jnet.collect_params(), optimizer, dict(opt),
                            fused=False)
    ttr = mx.gluon.Trainer(net.collect_params(), optimizer, dict(opt))
    jl = _train(jmx, jnet, jtr, batches)
    tl = _train(mx, net, ttr, batches, ctx=mx.cpu())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    want, got = _params(jnet), _params(net)
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-5,
            atol=1e-4 * max(np.abs(want[name]).max(), 1e-6), err_msg=name)
    want, got = _states(jnet, jtr), _states(net, ttr)
    assert sorted(want) == sorted(got)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for w, g in zip(want[name], got[name]):
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                err_msg=name)


def _load_common_state(jnet, jtr, net, ttr):
    """Set the port's weights, aux and optimizer states to the JAX
    Trainer's (the states through the JAX payload)."""
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with mx.cpu():
        params_from_numpy(net, arrays, prefix=jnet.prefix)
    mine = relative_names([p.name for p in ttr._params], net.prefix)
    theirs = relative_names([p.name for p in jtr._params], jnet.prefix)
    index_of = {theirs[p.name]: i for i, p in enumerate(jtr._params)}
    order = {i: index_of[mine[p.name]] for i, p in enumerate(ttr._params)}
    import pickle

    jstates = pickle.loads(jtr._updater.get_states())
    remapped = {i: jstates[j] for i, j in order.items() if j in jstates}
    payload = pickle.dumps(remapped)
    states = ttr._updater.states
    for i, p in enumerate(ttr._params):
        if i in remapped and i not in states:
            states[i] = ttr._optimizer.create_state_multi_precision(
                i, p.list_data()[0])
    ttr._updater.set_states(payload)


def test_resnet18_thumbnail_trainer_steps_match_jax():
    """Three SGD-momentum-wd steps of a ResNet-18 thumbnail; before the
    second and third the port takes the JAX Trainer's weights, aux and
    momentum (its state payload), so each step starts from a common
    state. Losses and running stats per tensor, weights and momentum by
    relative L2 over the net (as tests/test_torch_train_step.py, whose
    bounds these are: ReLU kinks flip in about one step of three)."""
    build = lambda pkg: (jvision if pkg is jmx else vision).resnet18_v1(
        classes=4, thumbnail=True)
    jnet, net = _pair(build, (4, 3, 16, 16), 2)
    batches = _batches(np.random.RandomState(3), 3, (4, 3, 16, 16), 4)
    opt = {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt),
                            fused=False)
    ttr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))

    def rel(want, got):
        num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
        den = sum(float(np.sum(want[n] ** 2)) for n in want)
        return (num / den) ** 0.5

    for k, batch in enumerate(batches):
        if k:
            _load_common_state(jnet, jtr, net, ttr)
        jl = _train(jmx, jnet, jtr, [batch])
        tl = _train(mx, net, ttr, [batch], ctx=mx.cpu())
        np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=1e-6)
        want, got = _params(jnet), _params(net)
        aux = [n for n in want if "running" in n]
        for name in aux:
            np.testing.assert_allclose(
                got[name], want[name], rtol=1e-5,
                atol=1e-5 * np.abs(want[name]).max(), err_msg=name)
        assert rel({n: want[n] for n in want if n not in aux},
                   {n: got[n] for n in want if n not in aux}) < 1e-3
        ws, gs = _states(jnet, jtr), _states(net, ttr)
        assert rel({n: ws[n][0] for n in ws}, {n: gs[n][0] for n in ws}) \
            < 5e-2
    assert ttr._applier.num_compiles >= 1


# -- fused == loop, inside the port ----------------------------------------------

def _port_net(hidden, n_in, n_out, seed=5, dtype=None, hybridize=False,
              ctx=None):
    ctx = ctx or mx.cpu()
    with ctx:
        net = _init(mx, lambda pkg: _dense_bn_dense(pkg, hidden, n_in, n_out),
                    (6, n_in), seed, ctx=ctx)
    if dtype is not None:
        net.cast(dtype)
    if hybridize:
        net.hybridize()
    return net


def _copy_net(src, **kw):
    net = _port_net(**kw)
    for p, q in zip(src.collect_params().values(),
                    net.collect_params().values()):
        q.set_data(p.data().copy())
    return net


def _fused_vs_loop(optimizer, opt, sizes=(13, 7, 3), dtype=None, steps=3,
                   trainer_kw=None, hybridize=False, between=None, ctx=None):
    """Train two copies of a net, fused and per parameter; returns their
    (trainer, net) pairs after asserting equality bit for bit."""
    ctx = ctx or mx.cpu()
    hidden, n_in, n_out = sizes
    base = _port_net(hidden, n_in, n_out, dtype=dtype, hybridize=hybridize,
                     ctx=ctx)
    kw = dict(hidden=hidden, n_in=n_in, n_out=n_out, dtype=dtype,
              hybridize=hybridize, ctx=ctx)
    nets = [base, _copy_net(base, **kw)]
    trainers = [mx.gluon.Trainer(n.collect_params(), optimizer, dict(opt),
                                 fused=f, **(trainer_kw or {}))
                for n, f in zip(nets, (True, False))]
    batches = _batches(np.random.RandomState(7), steps, (6, n_in), n_out)
    for k, batch in enumerate(batches):
        for n, t in zip(nets, trainers):
            if between is not None:
                between(k, n, t)
            _train(mx, n, t, [batch], ctx=ctx, dtype=dtype)
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(p.data().data_, q.data().data_), p.name
    sa, sb = (t._updater.states for t in trainers)
    assert sorted(sa) == sorted(sb)
    for i in sa:
        fa = [x for x in _leaves(sa[i])]
        fb = [x for x in _leaves(sb[i])]
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            assert a.data_.dtype == b.data_.dtype
            assert torch.equal(a.data_, b.data_), i
    assert trainers[1]._applier.num_compiles == 0
    return trainers, nets


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (list, tuple)):
        return [x for y in s for x in _leaves(y)]
    return [s]


FUSED_FAMILIES = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
    "sgd_plain": {"learning_rate": 0.1, "wd": 0.01},
    "nag": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
    "adam": {"learning_rate": 0.01, "wd": 0.001},
    "rmsprop": {"learning_rate": 0.01, "clip_weights": 0.8},
    "rmsprop_centered": {"learning_rate": 0.01, "centered": True},
    "adagrad": {"learning_rate": 0.05, "wd": 0.01},
    "adadelta": {"wd": 0.01},
    "signum": {"learning_rate": 0.01, "wd_lh": 0.01, "wd": 0.001},
    "signsgd": {"learning_rate": 0.01},
}
SIZES = {"odd": (13, 7, 3), "aligned": (32, 16, 8), "one": (1, 1001, 1)}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("case", sorted(FUSED_FAMILIES))
def test_fused_equals_loop_bit_for_bit(case, size):
    optimizer = {"sgd_plain": "sgd",
                 "rmsprop_centered": "rmsprop"}.get(case, case)
    opt = dict(FUSED_FAMILIES[case], clip_gradient=0.5)
    (tf, _), _ = _fused_vs_loop(optimizer, opt, sizes=SIZES[size])
    assert tf._applier.num_compiles >= 1


@pytest.mark.parametrize("case", ["sgd", "adam", "rmsprop_centered",
                                  "signum"])
def test_fused_equals_loop_bf16_multi_precision(case):
    optimizer = {"rmsprop_centered": "rmsprop"}.get(case, case)
    opt = dict(FUSED_FAMILIES[case], multi_precision=True)
    (tf, tl), (nf, _) = _fused_vs_loop(optimizer, opt, dtype="bfloat16")
    for i, st in tf._updater.states.items():
        inner, master = st
        assert isinstance(master, fused_update._FlatView)
        assert master.data_.dtype == torch.float32
        assert nf.collect_params()[tf._params[i].name].data().data_.dtype \
            == torch.bfloat16
    assert tf._applier.num_compiles >= 1


def test_fused_equals_loop_bf16_without_master():
    _fused_vs_loop("sgd", FUSED_FAMILIES["sgd"], dtype="bfloat16")


def test_fused_equals_loop_with_lr_and_wd_multipliers():
    """Per-parameter lr_mult/wd_mult give one value per element of the
    chunk's runtime lr/wd tensors."""
    def mults(k, net, trainer):
        if k == 0:
            for j, p in enumerate(net.collect_params().values()):
                p.lr_mult = 0.5 + 0.25 * j
                p.wd_mult = 0.0 if p.name.endswith("bias") else 2.0

    (tf, _), _ = _fused_vs_loop("adam", FUSED_FAMILIES["adam"],
                                between=mults)
    ch = next(iter(tf._applier._chunks.values()))
    assert ch.lr_t.ndim == 1 and ch.lr_t.numel() == ch.total


def test_fused_equals_loop_over_several_chunks(monkeypatch):
    monkeypatch.setattr(fused_update, "bucket_bytes", lambda: 256)
    (tf, _), _ = _fused_vs_loop("sgd", FUSED_FAMILIES["sgd"])
    assert len(tf._applier._chunks) > 2


def test_fused_equals_loop_with_global_norm_clip():
    (tf, _), _ = _fused_vs_loop("sgd", FUSED_FAMILIES["sgd"],
                                trainer_kw={"global_norm_clip": 0.5})


def test_fused_equals_loop_hybridized():
    _fused_vs_loop("nag", FUSED_FAMILIES["nag"], hybridize=True)


def test_fused_rereads_weights_written_elsewhere():
    """set_data between steps (and a learning-rate change) is seen by
    the next fused apply, which re-flattens from the live values."""
    def poke(k, net, trainer):
        if k == 1:
            p = list(net.collect_params().values())[0]
            p.set_data(p.data().asnumpy() * 0.5)
            trainer.set_learning_rate(0.03)

    _fused_vs_loop("sgd", FUSED_FAMILIES["sgd"], between=poke)


def test_fused_and_loop_toggle_mid_run():
    """fused=False after fused steps reads the flat state views (and
    writing them detaches the views); then fused again re-flattens."""
    def toggle(k, net, trainer):
        if k == 0:
            trainer.started_fused = trainer._fused
        if trainer.started_fused:
            trainer._fused = k != 1

    _fused_vs_loop("adam", FUSED_FAMILIES["adam"], steps=4, between=toggle)


def test_reader_of_the_weight_ndarray_sees_the_update():
    """The engine's version rule: a reader holding a weight's NDArray
    sees the new values and a bumped version after step(); a copy keeps
    the old values."""
    net = _port_net(13, 7, 3)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    w = list(net.collect_params().values())[0].data()
    snap = w.copy()
    v0 = w.version
    _train(mx, net, tr, _batches(np.random.RandomState(0), 1, (6, 7), 3),
           ctx=mx.cpu())
    assert w.version > v0
    assert not np.array_equal(w.asnumpy(), snap.asnumpy())
    assert w is list(net.collect_params().values())[0].data()


# -- Trainer behaviour against the JAX Trainer -----------------------------------

def _dbd_pair_trainers(opt, **kw):
    jnet, net = _pair(_dense_bn_dense, (8, 4), 3)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt),
                            fused=False, **kw)
    ttr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt), **kw)
    return jnet, net, jtr, ttr


def _assert_params_match(jnet, net):
    want, got = _params(jnet), _params(net)
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-5,
            atol=1e-4 * max(np.abs(want[name]).max(), 1e-6), err_msg=name)


def test_grad_req_add_accumulates_as_in_jax():
    jnet, net, jtr, ttr = _dbd_pair_trainers(FUSED_FAMILIES["sgd"])
    for pkg, n in ((jmx, jnet), (mx, net)):
        for p in n.collect_params().values():
            if p.grad_req != "null":
                p.grad_req = "add"
    batches = _batches(np.random.RandomState(4), 2, (8, 4), 3)
    _train(jmx, jnet, jtr, batches, backwards=2)
    _train(mx, net, ttr, batches, ctx=mx.cpu(), backwards=2)
    _assert_params_match(jnet, net)


def test_ignore_stale_grad_and_set_learning_rate_as_in_jax():
    jnet, net, jtr, ttr = _dbd_pair_trainers(FUSED_FAMILIES["sgd"])
    batches = _batches(np.random.RandomState(5), 3, (8, 4), 3)
    for k, b in enumerate(batches):
        for tr in (jtr, ttr):
            tr.set_learning_rate([0.1, 0.03, 0.3][k])
        jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
        tloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with jmx.autograd.record():
            jloss(jnet(jmx.nd.array(b[0])), jmx.nd.array(b[1])).backward()
        with mx.cpu(), mx.autograd.record():
            tloss(net(mx.nd.array(b[0])), mx.nd.array(b[1])).backward()
        jtr.step(8, ignore_stale_grad=True)
        ttr.step(8, ignore_stale_grad=True)
        assert ttr.learning_rate == jtr.learning_rate
    _assert_params_match(jnet, net)


def test_global_norm_clip_matches_jax():
    jnet, net, jtr, ttr = _dbd_pair_trainers(FUSED_FAMILIES["sgd"],
                                             global_norm_clip=0.3)
    batches = _batches(np.random.RandomState(6), 3, (8, 4), 3)
    _train(jmx, jnet, jtr, batches)
    _train(mx, net, ttr, batches, ctx=mx.cpu())
    _assert_params_match(jnet, net)
    with pytest.raises(ValueError):
        mx.gluon.Trainer(net.collect_params(), "sgd", global_norm_clip=0)


def test_learning_rate_follows_the_scheduler():
    net = _port_net(13, 7, 3)
    sched = mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.4, "lr_scheduler": sched})
    _train(mx, net, tr, _batches(np.random.RandomState(0), 3, (6, 7), 3),
           ctx=mx.cpu())
    jsched = jmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    jsched.base_lr = 0.4
    assert tr.learning_rate == jsched(3)


@pytest.mark.parametrize("fused", [True, False])
def test_save_and_load_states_resume_bit_for_bit(tmp_path, fused):
    """2 steps, save_states, a fresh Trainer over a copy of the net
    load_states, 2 more steps: equal to 4 uninterrupted steps, bit for
    bit (SGD momentum: no per-index count in the arithmetic)."""
    opt = FUSED_FAMILIES["sgd"]
    net = _port_net(13, 7, 3)
    ref = _copy_net(net, hidden=13, n_in=7, n_out=3)
    batches = _batches(np.random.RandomState(8), 4, (6, 7), 3)
    tr_ref = mx.gluon.Trainer(ref.collect_params(), "sgd", dict(opt),
                              fused=fused)
    _train(mx, ref, tr_ref, batches, ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                          fused=fused)
    _train(mx, net, tr, batches[:2], ctx=mx.cpu())
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    net2 = _copy_net(net, hidden=13, n_in=7, n_out=3)
    tr2 = mx.gluon.Trainer(net2.collect_params(), "sgd", dict(opt),
                           fused=fused)
    tr2.load_states(path)
    _train(mx, net2, tr2, batches[2:], ctx=mx.cpu())
    for p, q in zip(ref.collect_params().values(),
                    net2.collect_params().values()):
        assert torch.equal(p.data().data_, q.data().data_), p.name


@pytest.mark.parametrize("optimizer,dtype", [("adam", None),
                                             ("sgd", "bfloat16")])
def test_fused_and_loop_save_the_same_states(optimizer, dtype):
    """get_states of the fused Trainer (flat views) is the loop's
    payload, (inner, fp32 master) tuples included."""
    import pickle

    opt = dict(FUSED_FAMILIES[optimizer], multi_precision=dtype is not None)
    (tf, tl), _ = _fused_vs_loop(optimizer, opt, dtype=dtype)
    a = pickle.loads(tf._updater.get_states())
    b = pickle.loads(tl._updater.get_states())
    assert sorted(a) == sorted(b)

    def same(x, y):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                same(u, v)
        else:
            assert type(x) is type(y)
            np.testing.assert_array_equal(x, y)

    for i in a:
        same(a[i], b[i])
        if dtype is not None:
            assert a[i][1].dtype == np.float32


def test_jax_trainer_states_load_into_the_port(tmp_path):
    """A JAX Trainer's save_states file loads into the port's Trainer,
    which continues within the Dense-BN-Dense bound."""
    opt = FUSED_FAMILIES["sgd"]
    jnet, net, jtr, ttr = _dbd_pair_trainers(opt)
    batches = _batches(np.random.RandomState(9), 4, (8, 4), 3)
    _train(jmx, jnet, jtr, batches[:2])
    path = str(tmp_path / "j.states")
    jtr.save_states(path)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with mx.cpu():
        params_from_numpy(net, arrays, prefix=jnet.prefix)
    ttr.load_states(path)
    _train(jmx, jnet, jtr, batches[2:])
    _train(mx, net, ttr, batches[2:], ctx=mx.cpu())
    _assert_params_match(jnet, net)


def test_multi_context_and_dist_name_the_roadmap():
    # Several contexts and dist stores train now (tests/
    # test_torch_trainer_contexts.py, tests/test_torch_kvstore_dist.py);
    # row-sparse gradients still name their roadmap item.
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    tr = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert tr._contexts == [mx.cpu(0), mx.cpu(1)]
    net.weight._grad_stype = "row_sparse"
    with pytest.raises(NotImplementedError, match="Queue 1 item 11c"):
        tr.step(1)
    net2 = _port_net(13, 7, 3)
    tr = mx.gluon.Trainer(net2.collect_params(), "sgd",
                          update_on_kvstore=True)
    with pytest.raises(ValueError, match="update_on_kvstore"):
        tr.step(1)


def test_grad_guard_names_the_roadmap():
    # The guard is ported (telemetry.numerics): installed on the fused
    # applier it checks each step's chunks once, and finite steps pass.
    from mxnet_tpu_torch import telemetry

    net = _port_net(13, 7, 3)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert tr._applier.grad_guard is None
    guard = telemetry.NumericGuard(halt=True)
    assert guard.install(tr._applier) is tr._applier
    _train(mx, net, tr, _batches(np.random.RandomState(0), 2, (6, 7), 3),
           ctx=mx.cpu())
    assert guard.violations == [] and guard._counts == {"grad": 2}


def test_telemetry_counts_the_fused_path():
    from mxnet_tpu_torch import telemetry

    text0 = telemetry.render_prometheus()
    net = _port_net(13, 7, 3)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          FUSED_FAMILIES["sgd"])
    _train(mx, net, tr, _batches(np.random.RandomState(0), 2, (6, 7), 3),
           ctx=mx.cpu())
    text = telemetry.render_prometheus()
    for name in ("mx_trainer_update_seconds_count",
                 "mx_fused_apply_compiles_total",
                 "mx_trainer_fused_dispatches"):
        assert name in text, name
    assert text != text0


def test_naive_engine_runs_the_fused_step():
    mx.engine.set_engine_type("NaiveEngine")
    try:
        assert mx.engine.is_naive()
        _fused_vs_loop("sgd", FUSED_FAMILIES["sgd"], steps=1)
    finally:
        mx.engine.set_engine_type("ThreadedEnginePerDevice")
    assert not mx.engine.is_naive()


def test_env_knob_turns_the_fused_path_off(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_UPDATE", "0")
    net = _port_net(13, 7, 3)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert not tr._fused
    _train(mx, net, tr, _batches(np.random.RandomState(0), 1, (6, 7), 3),
           ctx=mx.cpu())
    assert tr._applier.num_compiles == 0


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("case", ["sgd", "nag", "adam", "rmsprop_centered",
                                  "adagrad", "adadelta", "signum"])
def test_fused_equals_loop_on_card(case, dtype):
    """On the card, at odd and aligned sizes, fp32 and bf16 with fp32
    masters: fused == loop bit for bit (nvcc contracts no multiply-add
    across the single-rounding ops of the bodies)."""
    _card()
    optimizer = {"rmsprop_centered": "rmsprop"}.get(case, case)
    opt = dict(FUSED_FAMILIES[case], multi_precision=dtype is not None,
               clip_gradient=0.5)
    for sizes in SIZES.values():
        _fused_vs_loop(optimizer, opt, sizes=sizes, dtype=dtype,
                       ctx=mx.gpu(0))


@pytest.mark.cuda
def test_card_trainer_matches_host_trainer():
    """One fused Adam Trainer run on the card and on the host from the
    same weights: within the Dense-BN-Dense bound."""
    _card()
    host = _port_net(13, 7, 3)
    card = _port_net(13, 7, 3, ctx=mx.gpu(0))
    for p, q in zip(host.collect_params().values(),
                    card.collect_params().values()):
        q.set_data(p.data().as_in_context(mx.gpu(0)))
    batches = _batches(np.random.RandomState(2), 3, (6, 7), 3)
    opt = FUSED_FAMILIES["adam"]
    for net, ctx in ((host, mx.cpu()), (card, mx.gpu(0))):
        tr = mx.gluon.Trainer(net.collect_params(), "adam", dict(opt))
        _train(mx, net, tr, batches, ctx=ctx)
    for p, q in zip(host.collect_params().values(),
                    card.collect_params().values()):
        want = p.data().asnumpy()
        np.testing.assert_allclose(q.data().asnumpy(), want, rtol=1e-5,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6))
