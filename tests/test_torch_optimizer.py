"""mxnet_tpu_torch's optimizer update ops, optimizer classes, lr
schedulers and Updater state payloads against the JAX package's.

Update ops and optimizer classes run on the same numpy weights,
gradients and states in both packages, fp32 on the host. The two agree
to a few float32 roundings: XLA on the host may contract a multiply-add
into one FMA where torch rounds twice, so the bound is stated per test
in units of float32's epsilon (2**-23 ~ 1.19e-7) relative to each
tensor's largest entry. bfloat16 weights with ``multi_precision`` are
compared on their fp32 masters (the same bound) and on the bf16 weights
(one bf16 rounding of the master). Schedulers are pure Python and must
give equal floats. Payloads cross in both directions; loading one never
imports the JAX package.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = 2.0 ** -23


def _close(got, want, ulps, err_msg=""):
    """|got - want| <= ulps * eps32 * max|want| elementwise."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * EPS32 * scale, err_msg=err_msg)


# -- update ops ----------------------------------------------------------------

OPS = {
    "adam_update": (["weight", "grad", "mean", "var"],
                    {"lr": 0.01, "beta1": 0.8, "beta2": 0.99}),
    "rmsprop_update": (["weight", "grad", "n"],
                       {"lr": 0.01, "gamma1": 0.8, "clip_weights": 0.9}),
    "rmspropalex_update": (["weight", "grad", "n", "g", "delta"],
                           {"lr": 0.01, "gamma1": 0.8, "gamma2": 0.7}),
    "ftrl_update": (["weight", "grad", "z", "n"],
                    {"lr": 0.1, "lamda1": 0.05, "beta": 1.5}),
    "ftml_update": (["weight", "grad", "d", "v", "z"],
                    {"lr": 0.01, "beta1": 0.6, "beta2": 0.99, "t": 3}),
    "signsgd_update": (["weight", "grad"], {"lr": 0.01}),
    "signum_update": (["weight", "grad", "mom"],
                      {"lr": 0.01, "momentum": 0.9, "wd_lh": 0.02}),
    "adagrad_update": (["weight", "grad", "history"], {"lr": 0.05}),
    "adadelta_update": (["weight", "grad", "acc_g", "acc_delta"],
                        {"rho": 0.8}),
}
# States that must stay non-negative (variances, histories).
POSITIVE = ("var", "n", "history", "acc_g", "acc_delta", "v", "d")


@pytest.mark.parametrize("clip", [-1.0, 0.4])
@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax(name, clip):
    """Every new update op, with rescale, wd and clip, on the same inputs
    (8 float32 ulps of each output's largest entry)."""
    names, attrs = OPS[name]
    rng = np.random.RandomState(11)
    arrays = []
    for n in names:
        a = rng.randn(6, 5).astype(np.float32)
        arrays.append(np.abs(a) + 0.1 if n in POSITIVE else a)
    clip_key = "clip_grad" if name == "ftml_update" else "clip_gradient"
    attrs = dict(attrs, wd=1e-2, rescale_grad=0.5, **{clip_key: clip})
    want = jreg.get(name).fn(*[jnp.asarray(a) for a in arrays], **attrs)
    got = treg.get(name).fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, 8, err_msg="output %d" % i)


def test_multi_sum_sq_matches_jax():
    rng = np.random.RandomState(12)
    arrays = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (7,), (2,))]
    want = jreg.get("multi_sum_sq").fn(*[jnp.asarray(a) for a in arrays],
                                       num_arrays=3)
    got = treg.get("multi_sum_sq").fn(*[torch.from_numpy(a)
                                        for a in arrays], num_arrays=3)
    _close(got.numpy(), want, 4)


def test_runtime_hyperparameters_give_the_python_float_result():
    """lr and wd handed in as tensors in the weight dtype (what the fused
    apply does) give the bits of the Python floats the loop passes, in
    float32 and in bfloat16."""
    rng = np.random.RandomState(13)
    for dtype in (torch.float32, torch.bfloat16):
        w, g, m, v = [torch.from_numpy(rng.randn(37).astype(np.float32))
                      .to(dtype) for _ in range(4)]
        v = v.abs()
        for name, states, kw in (("sgd_mom_update", (m,), {"momentum": .9}),
                                 ("adam_update", (m, v), {}),
                                 ("signum_update", (m,), {"momentum": .9,
                                                          "wd_lh": .1})):
            fn = treg.get(name).fn
            ref = fn(w, g, *states, lr=0.037, wd=0.0013, **kw)
            vec = fn(w, g, *states, lr=torch.full((37,), 0.037, dtype=dtype),
                     wd=torch.tensor(0.0013, dtype=dtype), **kw)
            for a, b in zip(ref, vec):
                assert torch.equal(a, b), (name, dtype)


# -- optimizer classes ---------------------------------------------------------

FAMILIES = {
    "sgd": {"momentum": 0.9},
    "sgd_plain": {},
    "nag": {"momentum": 0.9},
    "signum": {"wd_lh": 0.01},
    "signsgd": {},
    "adam": {"beta1": 0.8},
    "adagrad": {"eps": 1e-6},
    "adadelta": {"rho": 0.85},
    "rmsprop": {"clip_weights": 2.0},
    "rmsprop_centered": {"centered": True},
    "ftrl": {"lamda1": 0.02},
    "ftml": {},
    "nadam": {},
    "dcasgd": {"momentum": 0.9},
    "lbsgd": {"momentum": 0.9},
    "test": {},
}


def _family(case):
    return {"sgd_plain": "sgd", "rmsprop_centered": "rmsprop"}.get(case,
                                                                   case)


def _three_steps(case, dtype=None, mp=False):
    """(jax weights, port weights, jax updater, port updater) after three
    Updater steps over two parameters, with lr/wd multipliers, clip and
    rescale."""
    kw = dict(FAMILIES[case], learning_rate=0.05, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.8)
    if mp:
        kw["multi_precision"] = True
    jo = jmx.optimizer.create(_family(case), **kw)
    to = mx.optimizer.create(_family(case), **kw)
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({0: 2.0})
    ju, tu = jmx.optimizer.get_updater(jo), mx.optimizer.get_updater(to)
    rng = np.random.RandomState(21)
    ws = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    jw = [jmx.nd.array(w, dtype=dtype) for w in ws]
    tw = [mx.nd.array(w, ctx=mx.cpu(), dtype=dtype) for w in ws]
    for _ in range(3):
        for i, w in enumerate(ws):
            g = rng.randn(*w.shape).astype(np.float32)
            ju(i, jmx.nd.array(g, dtype=dtype), jw[i])
            with mx.cpu():
                tu(i, mx.nd.array(g, dtype=dtype), tw[i])
    return jw, tw, ju, tu


def _flat_states(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _flat_states(s)]
    return [state]


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_optimizer_three_steps_match_jax(case):
    """Weights and every state tensor after three steps (16 ulps of the
    largest entry: up to three steps of a few roundings each)."""
    jw, tw, ju, tu = _three_steps(case)
    for j, t in zip(jw, tw):
        _close(t.asnumpy(), j.asnumpy(), 16)
    for i in ju.states:
        js, ts = _flat_states(ju.states[i]), _flat_states(tu.states[i])
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            _close(t.asnumpy(), j.asnumpy(), 16, err_msg="state %d" % i)


@pytest.mark.parametrize("case", ["sgd", "nag", "adam", "rmsprop",
                                  "adagrad", "signum"])
def test_bf16_multi_precision_matches_jax(case):
    """bf16 weights with fp32 masters: the state is (inner, master) in
    both packages; masters within 16 ulps, weights within one bf16
    rounding of the master."""
    jw, tw, ju, tu = _three_steps(case, dtype="bfloat16", mp=True)
    for i in ju.states:
        jinner, jmaster = ju.states[i]
        tinner, tmaster = tu.states[i]
        assert tmaster.data_.dtype == torch.float32
        _close(tmaster.asnumpy(), np.asarray(jmaster.asnumpy(), np.float32),
               16)
        for j, t in zip(_flat_states(jinner), _flat_states(tinner)):
            _close(t.asnumpy(), np.asarray(j.asnumpy(), np.float32), 16)
        assert tw[i].data_.dtype == torch.bfloat16
        np.testing.assert_allclose(
            tw[i].asnumpy(), np.asarray(jw[i].asnumpy(), np.float32),
            rtol=2.0 ** -8, atol=1e-6)


def test_sgld_noise_has_the_langevin_scale():
    """SGLD adds N(0, lr) noise to the half-step: the port's RNG differs
    from the JAX package's, so the draw is checked by its moments."""
    lr = 0.04
    o = mx.optimizer.create("sgld", learning_rate=lr)
    with mx.cpu():
        w = mx.nd.zeros((200, 100))
        o.update(0, w, mx.nd.zeros((200, 100)), None)
    noise = w.asnumpy()
    assert abs(noise.mean()) < 0.01
    assert abs(noise.std() - lr ** 0.5) < 0.01


def _own(registry, module):
    """Registry names of the classes `module` itself defines (a test in
    the same process may register more)."""
    return sorted(k for k in registry.keys()
                  if registry.get(k).__module__ == module)


def test_registry_names_match_jax():
    assert _own(mx.optimizer.registry, "mxnet_tpu_torch.optimizer") == \
        _own(jmx.optimizer.registry, "mxnet_tpu.optimizer")
    with pytest.raises(ValueError):
        mx.optimizer.create("nope")


def test_sparse_helpers_name_the_roadmap():
    from mxnet_tpu_torch import optimizer

    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        optimizer._sparse_sgd_update(None, None, None, 0.1, 0, 0, 1, -1,
                                     True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        mx.gluon.Parameter("w", shape=(2, 2), grad_stype="row_sparse")


# -- lr schedulers --------------------------------------------------------------

SCHEDULERS = {
    "factor": ("FactorScheduler", {"step": 7, "factor": 0.7,
                                   "stop_factor_lr": 1e-3}),
    "factor_warmup": ("FactorScheduler", {"step": 5, "factor": 0.5,
                                          "warmup_steps": 10,
                                          "warmup_begin_lr": 0.001}),
    "multifactor": ("MultiFactorScheduler", {"step": [10, 25, 40],
                                             "factor": 0.3}),
    "multifactor_warmup": ("MultiFactorScheduler",
                           {"step": [20, 30], "factor": 0.1,
                            "warmup_steps": 8, "warmup_mode": "constant",
                            "warmup_begin_lr": 0.02}),
    "poly": ("PolyScheduler", {"max_update": 60, "pwr": 2,
                               "final_lr": 1e-4}),
    "poly_warmup": ("PolyScheduler", {"max_update": 60, "pwr": 1,
                                      "warmup_steps": 6}),
    "cosine": ("CosineScheduler", {"max_update": 60, "final_lr": 1e-3}),
    "cosine_warmup": ("CosineScheduler", {"max_update": 60,
                                          "warmup_steps": 12,
                                          "warmup_begin_lr": 0.0}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_scheduler_sequence_is_equal(case):
    name, kw = SCHEDULERS[case]
    js = getattr(jmx.lr_scheduler, name)(base_lr=0.1, **kw)
    ts = getattr(mx.lr_scheduler, name)(base_lr=0.1, **kw)
    want = [js(n) for n in range(80)]
    got = [ts(n) for n in range(80)]
    assert got == want


def test_scheduler_drives_the_optimizer_lr_as_in_jax():
    kw = {"learning_rate": 0.2, "momentum": 0.5}
    jo = jmx.optimizer.create("sgd", lr_scheduler=jmx.lr_scheduler
                              .FactorScheduler(step=2, factor=0.5), **kw)
    to = mx.optimizer.create("sgd", lr_scheduler=mx.lr_scheduler
                             .FactorScheduler(step=2, factor=0.5), **kw)
    for _ in range(7):
        jo._update_count(0)
        to._update_count(0)
        assert to._get_lr(0) == jo._get_lr(0)


# -- Updater state payloads ------------------------------------------------------

def _updaters(case="adam"):
    kw = dict(FAMILIES[case], learning_rate=0.05, wd=0.01)
    return (jmx.optimizer.get_updater(jmx.optimizer.create(_family(case),
                                                           **kw)),
            mx.optimizer.get_updater(mx.optimizer.create(_family(case),
                                                         **kw)))


def _drive(u, pkg, ws, grads, ctx=None):
    for step in grads:
        for i, g in enumerate(step):
            if ctx is None:
                u(i, pkg.nd.array(g), ws[i])
            else:
                with ctx:
                    u(i, pkg.nd.array(g), ws[i])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", ["adam", "sgd", "rmsprop_centered"])
def test_states_cross_packages_and_continue(case, direction):
    """Two steps in one package, get_states, set_states in a fresh
    updater of the other, two more steps there: the same as four steps
    in the first (16 ulps; the first package continues as reference).
    Counts are not part of a payload, so both sides restart Adam's t."""
    rng = np.random.RandomState(31)
    ws = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) for w in ws]
             for _ in range(4)]
    ju, tu = _updaters(case)
    jw = [jmx.nd.array(w) for w in ws]
    tw = [mx.nd.array(w, ctx=mx.cpu()) for w in ws]
    if direction == "jax_to_port":
        _drive(ju, jmx, jw, grads[:2])
        payload = ju.get_states()
        with mx.cpu():
            tu.set_states(payload)
            tw = [mx.nd.array(w.asnumpy()) for w in jw]
        ju2 = jmx.optimizer.get_updater(ju.optimizer.__class__(
            **{k: v for k, v in FAMILIES[case].items()},
            learning_rate=0.05, wd=0.01))
        ju2.set_states(payload)
        _drive(ju2, jmx, jw, grads[2:])
        _drive(tu, mx, tw, grads[2:], mx.cpu())
    else:
        _drive(tu, mx, tw, grads[:2], mx.cpu())
        payload = tu.get_states()
        ju.set_states(payload)
        jw = [jmx.nd.array(w.asnumpy()) for w in tw]
        tu2 = mx.optimizer.get_updater(mx.optimizer.create(
            _family(case), learning_rate=0.05, wd=0.01, **FAMILIES[case]))
        with mx.cpu():
            tu2.set_states(payload)
        _drive(ju, jmx, jw, grads[2:])
        _drive(tu2, mx, tw, grads[2:], mx.cpu())
    for j, t in zip(jw, tw):
        _close(t.asnumpy(), j.asnumpy(), 16)


def test_set_states_places_states_by_state_ctx():
    ju, tu = _updaters("sgd")
    jw = [jmx.nd.array(np.ones((3,), np.float32))]
    _drive(ju, jmx, jw, [[np.ones((3,), np.float32)]])
    tu.state_ctx = lambda index: mx.cpu()
    tu.set_states(ju.get_states())     # no `with mx.cpu()`: the default
    assert tu.states[0].context == mx.cpu()     # context is gpu(0)


def test_dumped_jax_optimizer_loads_as_the_port_class():
    ju, _ = _updaters("adam")
    jw = [jmx.nd.array(np.ones((3,), np.float32))]
    _drive(ju, jmx, jw, [[np.ones((3,), np.float32)]])
    payload = ju.get_states(dump_optimizer=True)
    tu = mx.optimizer.get_updater(mx.optimizer.create("sgd"))
    with mx.cpu():
        tu.set_states(payload)
    assert type(tu.optimizer) is mx.optimizer.Adam
    assert tu.optimizer.beta1 == ju.optimizer.beta1
    np.testing.assert_array_equal(tu.states[0][0].asnumpy(),
                                  ju.states[0][0].asnumpy())


def test_other_jax_package_names_are_refused():
    """A payload naming a JAX-package class other than an optimizer or a
    scheduler (here a gluon Parameter, protocol 2 GLOBAL) is refused."""
    payload = b"\x80\x02cmxnet_tpu.gluon.parameter\nParameter\nq\x00."
    tu = mx.optimizer.get_updater(mx.optimizer.create("sgd"))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tu.set_states(payload)


def test_loading_a_jax_payload_leaves_the_jax_package_unloaded(tmp_path):
    """A payload the JAX package wrote with dump_optimizer=True, loaded
    by the port in a fresh process: neither jax nor mxnet_tpu is in
    sys.modules afterwards."""
    ju, _ = _updaters("adam")
    jw = [jmx.nd.array(np.ones((3,), np.float32))]
    _drive(ju, jmx, jw, [[np.ones((3,), np.float32)]])
    path = tmp_path / "states.pkl"
    path.write_bytes(ju.get_states(dump_optimizer=True))
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mx\n"
        "u = mx.optimizer.get_updater(mx.optimizer.create('sgd'))\n"
        "u.state_ctx = lambda i: mx.cpu()\n"
        "u.set_states(open(%r, 'rb').read())\n"
        "assert type(u.optimizer).__module__ == 'mxnet_tpu_torch.optimizer'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % str(path))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
