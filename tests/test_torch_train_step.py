"""mxnet_tpu_torch TrainStep against the JAX package's TrainStep.

Both packages build the same net; the JAX net's weights (with random
BatchNorm statistics, gamma and beta) are carried to the port's net with
`params_from_numpy`. The JAX side runs `TrainStep` on a one-device mesh,
`make_mesh({"dp": 1}, devices=[jax.devices()[0]])`; the port's on
`make_mesh({"dp": 1}, devices=[mx.cpu()])`. Same numpy batches, three
SGD-momentum steps with weight decay; per-step losses, final weights,
momentum and BatchNorm running statistics must agree.

Tolerances (fp32). Dense-BN-Dense, three steps in a row: losses rtol
1e-5 / atol 1e-6; state (weights, momentum, running stats) rtol 1e-5
and atol 1e-4 of each tensor's largest magnitude, because the gradient
of the bias that feeds BatchNorm is zero up to cancellation, so that
bias moves by its weight decay plus rounding noise at the 4e-5 level of
its own size. That noise is as small in the port as in the JAX package
only because the port's BatchNorm differentiates its variance through
the centered values, as autodiff of jnp.var does (tests/test_torch_ops.py
holds that op alone); with torch.var's own backward the port's momentum
of that bias lay about three times farther from a float64 run than the
JAX package's, and exceeded the tolerance at some seeds. ResNet-18: see
its test (ReLU flips at rounding level).
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names
from mxnet_tpu_torch.parallel import TrainStep, make_mesh

torch.set_num_threads(2)

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}


def _dense_bn_dense(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4))
    net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(2, in_units=8))
    return net


def _randomize(net, rng):
    for name, p in net.collect_params().items():
        if name.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "bias")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
        elif name.endswith("gamma"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))


def _pair(build, x_shape, seed):
    """(jax net, port net) with the same weights."""
    rng = np.random.RandomState(seed)
    jnet = build(jmx)
    jnet.initialize()
    with jmx.autograd.pause():
        jnet(jmx.nd.array(rng.rand(*x_shape).astype(np.float32)))
    _randomize(jnet, rng)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with mx.cpu():
        net = build(mx)
        net.initialize(ctx=mx.cpu())
        params_from_numpy(net, arrays, prefix=jnet.prefix)
    return jnet, net


def _steps(jnet, net, batches, optimizer="sgd", opt=OPT, dtype=None,
           lr_schedule=None):
    """Run both TrainSteps over `batches`; returns (jax step, port step,
    jax losses, port losses)."""
    jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jstep = JTrainStep(jnet, jloss, optimizer=optimizer,
                       optimizer_params=dict(opt),
                       mesh=jmake_mesh({"dp": 1},
                                       devices=[jax.devices()[0]]),
                       dtype=dtype)
    tstep = TrainStep(net, tloss, optimizer=optimizer,
                      optimizer_params=dict(opt),
                      mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]),
                      dtype=dtype)
    jl, tl = [], []
    for i, (x, y) in enumerate(batches):
        if lr_schedule is not None:
            jstep.set_learning_rate(lr_schedule[i])
            tstep.set_learning_rate(lr_schedule[i])
        jl.append(float(jax.device_get(jstep(x, y))))
        tl.append(float(tstep(x, y)))
    return jstep, tstep, np.array(jl), np.array(tl)


def _by_relative(names_to_arrays, prefix):
    rel = relative_names(list(names_to_arrays), prefix)
    return {rel[n]: v for n, v in names_to_arrays.items()}


def _compare_state(jstep, tstep, jnet, net, rtol, atol_frac):
    """Params, optimizer state and aux of the two steps, matched by
    relative name; atol is `atol_frac` of each tensor's largest
    magnitude."""
    jp, js, ja = jstep.state_to_host()
    tp, ts, ta = tstep.state_to_host()
    for jd, td in ((jp, tp), (ja, ta)):
        want = _by_relative({n: np.asarray(v) for n, v in jd.items()},
                            jnet.prefix)
        got = _by_relative(td, net.prefix)
        assert sorted(want) == sorted(got)
        for name in want:
            w = want[name]
            np.testing.assert_allclose(
                got[name], w, rtol=rtol,
                atol=atol_frac * max(np.abs(w).max(), 1e-6), err_msg=name)
    want = _by_relative({n: np.asarray(s[0]) for n, s in js.items() if s},
                        jnet.prefix)
    got = _by_relative({n: s[0] for n, s in ts.items() if s}, net.prefix)
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol_frac * max(
                                       np.abs(want[name]).max(), 1e-6),
                                   err_msg="momentum " + name)


def _batches(rng, n, x_shape, classes):
    return [(rng.rand(*x_shape).astype(np.float32) * 3 - 1,
             rng.randint(0, classes, x_shape[0]).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("optimizer,opt", [
    ("sgd", OPT),
    ("sgd", {"learning_rate": 0.2, "wd": 0.01}),
    ("nag", OPT),
])
def test_dense_bn_dense_three_steps_match_jax(optimizer, opt):
    """Losses, weights (biases and BatchNorm gamma/beta decayed too),
    momentum and BatchNorm running stats (batch statistics, committed as
    aux) after three steps."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 0)
    batches = _batches(np.random.RandomState(1), 3, (8, 4), 2)
    jstep, tstep, jl, tl = _steps(jnet, net, batches, optimizer, opt)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    _compare_state(jstep, tstep, jnet, net, rtol=1e-5, atol_frac=1e-4)
    if opt.get("momentum"):
        assert all(len(s) == 1 for s in tstep.state_to_host()[1].values())


def _load_jax_state(tstep, jstep, jnet, net):
    """Copy the JAX step's params, momentum and aux into the port's."""
    jp, js, ja = jstep.state_to_host()
    mine = relative_names(list(tstep._param_vals) + list(tstep._aux_vals),
                          net.prefix)
    theirs = _by_relative({n: n for n in list(jp) + list(ja)}, jnet.prefix)
    with torch.no_grad():
        for n, v in tstep._param_vals.items():
            v.copy_(torch.from_numpy(np.array(jp[theirs[mine[n]]])))
            for s, js_ in zip(tstep._opt_state[n], js[theirs[mine[n]]]):
                s.copy_(torch.from_numpy(np.array(js_)))
        for n, v in tstep._aux_vals.items():
            v.copy_(torch.from_numpy(np.array(ja[theirs[mine[n]]])))


def _global_rel(want, got):
    """Relative L2 error over every tensor of a {name: array} state."""
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    den = sum(float(np.sum(want[n] ** 2)) for n in want)
    return (num / den) ** 0.5


def test_resnet18_thumbnail_three_steps_match_jax():
    """Three SGD-momentum-wd steps; before the second and third the
    port's state is set to the JAX step's, so each step starts from a
    common state (with a running momentum). Losses and BatchNorm running
    stats are compared tensor by tensor. Weights and momentum are
    compared by their relative L2 error over the whole net: with
    BatchNorm over 2x2 maps at batch 4, a ReLU whose input lies within
    rounding of zero takes the other side in one package in about one
    step of three, and moves the gradients upstream of it by up to a few
    percent of a tensor's largest entry. Measured over 12 seeds: weights
    <= 1.7e-4 and momentum <= 1.6e-2 with such a flip, 5e-8 and 4e-6
    without; a float64 run of the port sides with either package as
    often as the other."""
    jnet, net = _pair(
        lambda pkg: (jvision if pkg is jmx else vision).resnet18_v1(
            classes=4, thumbnail=True), (4, 3, 16, 16), 2)
    batches = _batches(np.random.RandomState(3), 3, (4, 3, 16, 16), 4)
    opt = {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}
    jstep, tstep, jl, tl = _steps(jnet, net, batches[:1], opt=opt)
    for k, (x, y) in enumerate(batches):
        if k:
            _load_jax_state(tstep, jstep, jnet, net)
            jl = np.append(jl, float(jax.device_get(jstep(x, y))))
            tl = np.append(tl, float(tstep(x, y)))
        jp, js, ja = jstep.state_to_host()
        tp, ts, ta = tstep.state_to_host()
        want = _by_relative({n: np.asarray(v) for n, v in ja.items()},
                            jnet.prefix)
        got = _by_relative(ta, net.prefix)
        for name in want:
            np.testing.assert_allclose(
                got[name], want[name], rtol=1e-5,
                atol=1e-5 * np.abs(want[name]).max(), err_msg=name)
        assert _global_rel(
            _by_relative({n: np.asarray(v) for n, v in jp.items()},
                         jnet.prefix), _by_relative(tp, net.prefix)) < 1e-3
        assert _global_rel(
            _by_relative({n: np.asarray(s[0]) for n, s in js.items()},
                         jnet.prefix),
            _by_relative({n: s[0] for n, s in ts.items()},
                         net.prefix)) < 5e-2
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=1e-6)
    assert tstep.num_update == 3


def test_set_learning_rate_between_steps_matches_jax():
    """The learning rate is a runtime value: a schedule applied between
    steps gives the JAX trajectory."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 4)
    batches = _batches(np.random.RandomState(5), 3, (8, 4), 2)
    jstep, tstep, jl, tl = _steps(jnet, net, batches,
                                  lr_schedule=[0.1, 0.05, 0.5])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    _compare_state(jstep, tstep, jnet, net, rtol=1e-5, atol_frac=1e-4)
    assert tstep.num_update == jstep.num_update == 3


def test_sync_to_net_matches_jax():
    """The net keeps its weights until sync_to_net; then it holds the
    step's, as the JAX net does."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 6)
    before = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    batches = _batches(np.random.RandomState(7), 2, (8, 4), 2)
    jstep, tstep, _, _ = _steps(jnet, net, batches)
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[n])
    jstep.sync_to_net()
    tstep.sync_to_net()
    want = _by_relative({n: p.data().asnumpy()
                         for n, p in jnet.collect_params().items()},
                        jnet.prefix)
    got = _by_relative({n: p.data().asnumpy()
                        for n, p in net.collect_params().items()},
                       net.prefix)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # The net's arrays are copies: a further step leaves them alone.
    snap = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    tstep(*batches[0])
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), snap[n])


def test_bf16_masters_and_momentum_stay_fp32():
    """dtype="bfloat16": masters, momentum and aux stay fp32 and the
    loss is fp32; the losses follow the JAX bf16 run to bf16 accuracy
    (the two frameworks round to bf16 at other places)."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 8)
    batches = _batches(np.random.RandomState(9), 3, (8, 4), 2)
    jstep, tstep, jl, tl = _steps(jnet, net, batches, dtype="bfloat16")
    for v in tstep._param_vals.values():
        assert v.dtype == torch.float32
    for st in tstep._opt_state.values():
        assert all(s.dtype == torch.float32 for s in st)
    for v in tstep._aux_vals.values():
        assert v.dtype == torch.float32
    assert tstep(*batches[0]).dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)


def test_float64_compute_dtype_keeps_the_loss_in_float64():
    """A compute dtype of fp32 or wider keeps its own precision through
    the loss; masters and momentum stay fp32."""
    _, net = _pair(_dense_bn_dense, (8, 4), 16)
    x, y = _batches(np.random.RandomState(17), 1, (8, 4), 2)[0]
    step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]),
                     dtype="float64")
    assert step(x, y).dtype == torch.float64
    assert all(v.dtype == torch.float32 for v in step._param_vals.values())
    assert all(s.dtype == torch.float32 for st in step._opt_state.values()
               for s in st)


def _jax_self_attention(units, heads):
    """The JAX package's twin of examples.attention_layer.SelfAttention."""
    class SelfAttention(jmx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.qkv = jmx.gluon.nn.Dense(3 * units, flatten=False,
                                          in_units=units)
            self.proj = jmx.gluon.nn.Dense(units, flatten=False,
                                           in_units=units)

        def hybrid_forward(self, F, x):
            b, t, c = x.shape
            qkv = self.qkv(x).reshape((b, t, 3, heads, c // heads)) \
                .transpose((2, 0, 3, 1, 4))
            out = F.contrib.flash_attention(qkv[0], qkv[1], qkv[2],
                                            causal=True)
            return self.proj(out.transpose((0, 2, 1, 3)).reshape((b, t, c)))

    return SelfAttention()


def test_self_attention_layer_steps_match_jax():
    """The attention layer chip_smoke.py trains (flash attention forward
    and backward inside TrainStep), at 2 heads x 8, T 16: two
    SGD-momentum steps with L2Loss against the JAX TrainStep over the
    Pallas op in interpret mode. No ReLU, so elementwise fp32 tolerances:
    losses rtol 1e-5, weights and momentum rtol 1e-5 / atol 1e-4 of each
    tensor's largest entry."""
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention

    units, heads = 16, 2
    jnet, net = _pair(lambda pkg: _jax_self_attention(units, heads)
                      if pkg is jmx else SelfAttention(units, heads=heads),
                      (2, 16, units), 18)
    rng = np.random.RandomState(19)
    batches = [(rng.randn(2, 16, units).astype(np.float32),
                rng.randn(2, 16, units).astype(np.float32))
               for _ in range(2)]
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    jstep = JTrainStep(jnet, jmx.gluon.loss.L2Loss(), "sgd", dict(opt),
                       mesh=jmake_mesh({"dp": 1}, devices=[jax.devices()[0]]))
    tstep = TrainStep(net, mx.gluon.loss.L2Loss(), "sgd", dict(opt),
                      mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
    for x, y in batches:
        np.testing.assert_allclose(float(tstep(x, y)),
                                   float(jax.device_get(jstep(x, y))),
                                   rtol=1e-5)
    _compare_state(jstep, tstep, jnet, net, rtol=1e-5, atol_frac=1e-4)


def _probe(pkg, seen):
    """A block that records (is_recording, is_training) when it runs."""
    class Probe(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            seen.append((pkg.autograd.is_recording(),
                         pkg.autograd.is_training()))
            return x

    return Probe()


def test_step_runs_the_net_in_train_mode_with_recording_paused():
    seen = {"jax": [], "port": []}

    def build(pkg):
        net = _dense_bn_dense(pkg)
        net.add(_probe(pkg, seen["jax" if pkg is jmx else "port"]))
        return net

    jnet, net = _pair(build, (8, 4), 10)
    seen["jax"].clear()
    seen["port"].clear()
    batches = _batches(np.random.RandomState(11), 1, (8, 4), 2)
    _steps(jnet, net, batches)
    assert seen["port"] == [(False, True)]
    assert seen["jax"][-1] == (False, True)


def test_null_grad_req_parameter_is_aux_and_not_updated():
    """A parameter with grad_req="null" is aux state: no gradient, no
    weight decay; it keeps its value, in both packages."""
    jnet, net = _pair(_dense_bn_dense, (8, 4), 12)
    jnet[0].bias.grad_req = "null"
    net[0].bias.grad_req = "null"
    bias0 = net[0].bias.data().asnumpy()
    batches = _batches(np.random.RandomState(13), 2, (8, 4), 2)
    jstep, tstep, jl, tl = _steps(jnet, net, batches)
    assert net[0].bias in tstep._aux_params
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    tstep.sync_to_net()
    np.testing.assert_array_equal(net[0].bias.data().asnumpy(), bias0)


def test_loss_is_the_mean_of_the_per_sample_loss():
    """The returned loss is the batch mean of loss_fn, and one plain SGD
    step moves each weight by -lr times that mean's gradient."""
    rng = np.random.RandomState(14)
    x = rng.rand(6, 4).astype(np.float32)
    y = rng.rand(6, 2).astype(np.float32)
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=4)
        net.initialize(ctx=mx.cpu())
        w0 = net.weight.data().asnumpy()
        b0 = net.bias.data().asnumpy()
    step = TrainStep(net, mx.gluon.loss.L2Loss(),
                     optimizer_params={"learning_rate": 0.5},
                     mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
    loss = float(step(x, y))
    err = x @ w0.T + b0 - y
    np.testing.assert_allclose(loss, np.mean(np.mean(err ** 2 / 2, axis=1)),
                               rtol=1e-6)
    grad_w = (err.T @ x) / err.size
    params = step.state_to_host()[0]
    np.testing.assert_allclose(params[net.weight.name], w0 - 0.5 * grad_w,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["adam", "rmsprop", "sgld"])
def test_other_optimizer_families_name_the_roadmap(family):
    """These families raised (ROADMAP Queue 1 item 3) until the port's
    TrainStep took every family of the JAX TrainStep: each now builds
    and steps; an unknown family still raises, naming gluon.Trainer."""
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=mx.cpu())
    step = TrainStep(net, mx.gluon.loss.L2Loss(), optimizer=family,
                     mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
    loss = step(np.ones((4, 3), np.float32), np.zeros((4, 2), np.float32))
    assert np.isfinite(float(loss)) and step.num_update == 1
    with pytest.raises(ValueError, match="gluon.Trainer"):
        TrainStep(net, mx.gluon.loss.L2Loss(), optimizer="nope",
                  mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))


def _dense_bn_dense_nobias(pkg):
    """No bias before BatchNorm: its gradient is zero in exact arithmetic,
    and a scale-free family (Adam, AdaGrad, RMSProp, Signum) would step
    by the sign of each package's rounding noise there."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4, use_bias=False))
    net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(2, in_units=8))
    return net


FAMILIES = {
    "signum": ("signum", {"learning_rate": 0.01, "wd": 0.01,
                          "wd_lh": 0.01}),
    "signsgd": ("signsgd", {"learning_rate": 0.01}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.001, "beta1": 0.8}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "gamma1": 0.8}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.05, "eps": 1e-6}),
    "adadelta": ("adadelta", {"rho": 0.8, "wd": 0.01}),
    "ftrl": ("ftrl", {"learning_rate": 0.1, "lamda1": 0.001}),
    "ftml": ("ftml", {"learning_rate": 0.01}),
    "nadam": ("nadam", {"learning_rate": 0.01, "clip_gradient": 0.5}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9,
                          "wd": 0.01}),
    "lbsgd": ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
                        "wd": 0.01}),
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_other_families_three_steps_match_jax(case):
    """Every family the JAX TrainStep accepts beyond sgd/nag: losses,
    weights, each optimizer-state tensor and the running stats after
    three steps (rtol 1e-5, atol 1e-4 of each tensor's largest entry, the
    Dense-BN-Dense bound above; Adam's lr_t is fp32 arithmetic there and
    Python floats here)."""
    optimizer, opt = FAMILIES[case]
    jnet, net = _pair(_dense_bn_dense_nobias, (8, 4), 0)
    batches = _batches(np.random.RandomState(1), 3, (8, 4), 2)
    jstep, tstep, jl, tl = _steps(jnet, net, batches, optimizer, opt)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    jp, js, ja = jstep.state_to_host()
    tp, ts, ta = tstep.state_to_host()
    for jd, td in ((jp, tp), (ja, ta)):
        want = _by_relative({n: np.asarray(v) for n, v in jd.items()},
                            jnet.prefix)
        got = _by_relative(td, net.prefix)
        for name in want:
            np.testing.assert_allclose(
                got[name], want[name], rtol=1e-5,
                atol=1e-4 * max(np.abs(want[name]).max(), 1e-6),
                err_msg=name)
    want = _by_relative({n: [np.asarray(x) for x in s]
                         for n, s in js.items()}, jnet.prefix)
    got = _by_relative(ts, net.prefix)
    assert sorted(want) == sorted(got)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for w, g in zip(want[name], got[name]):
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                err_msg="state " + name)


def test_sgld_step_adds_noise_of_the_langevin_scale():
    """SGLD's noise comes from the port's generator, so its draw is held
    to its moments: with a zero gradient (L2 loss at the optimum) the
    step is N(0, lr) noise."""
    lr = 0.01
    with mx.cpu():
        net = mx.gluon.nn.Dense(64, in_units=64, use_bias=False)
        net.initialize(ctx=mx.cpu())
    w0 = net.weight.data().asnumpy()
    step = TrainStep(net, mx.gluon.loss.L2Loss(), optimizer="sgld",
                     optimizer_params={"learning_rate": lr},
                     mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
    x = np.zeros((4, 64), np.float32)
    step(x, np.zeros((4, 64), np.float32))
    d = step.state_to_host()[0][net.weight.name] - w0
    assert abs(d.mean()) < 0.01
    assert abs(d.std() - lr ** 0.5) < 0.01


@pytest.mark.parametrize("axes,devices", [
    ({"dp": 2}, 2), ({"dp": 1, "tp": 2}, 2), ({"dp": -1}, 3)])
def test_multi_device_mesh_names_the_roadmap(axes, devices):
    # One process runs one device: a mesh over several is a mesh over the
    # ranks of parallel.dist (tests/test_torch_dist.py).
    with pytest.raises(NotImplementedError, match="one device per process"):
        make_mesh(axes, devices=[mx.cpu()] * devices)


def test_single_device_mesh_places_on_its_device():
    from mxnet_tpu_torch.parallel import data_sharding, replicate

    mesh = make_mesh({"dp": -1}, devices=[mx.cpu()])
    assert mesh.shape == {"dp": 1}
    assert data_sharding(mesh) == replicate(mesh) == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh({"dp": 2}, devices=[mx.cpu()])


def test_train_imagenet_driver_runs_on_the_host():
    """The port's train_imagenet driver (the benchmark protocol) on a
    small ResNet on the host; every network it lists builds, and a name
    it does not list raises."""
    from mxnet_tpu_torch.examples import train_imagenet

    rate = train_imagenet.benchmark_rate(
        "resnet18", batch=2, device=mx.cpu(), image_shape=(3, 32, 32),
        num_classes=10, iters=1, windows=1, warmup=1)
    assert rate > 0
    assert type(train_imagenet.build_net("alexnet", 10, ctx=mx.cpu())) \
        .__name__ == "AlexNet"
    with pytest.raises(KeyError):
        train_imagenet.build_net("lenet", 10, ctx=mx.cpu())
