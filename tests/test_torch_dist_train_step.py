"""TrainStep over a dp mesh of ranks against the JAX package's GSPMD step.

The port's ranks (2 and 4, gloo on the host, launched through
``parallel.launch``; tests/torch_dist_prog.py ``spmd_trainstep``) each
feed their local slice of the global batch; the JAX TrainStep runs on
``make_mesh({"dp": n})`` over the suite's virtual CPU devices, fed the
global batch. The net is the Dense-BN-Dense of
tests/test_torch_train_step.py with random BatchNorm state, three
SGD-momentum steps with weight decay; the batch's slices have different
means, so BatchNorm over each rank's own rows (as DDP's is) gives a
different step, and the test holds that it does. Nets here have no
dropout: the JAX step draws one key for the global batch and each of
the port's ranks draws its own stream.

Tolerances are tests/test_torch_train_step.py's (fp32): losses rtol
1e-5 / atol 1e-6; weights, momentum and running statistics rtol 1e-5
and atol 1e-4 of each tensor's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names
from mxnet_tpu_torch.parallel import TrainStep, make_mesh

from torch_dist_prog import OPT, dense_bn_dense, launch

torch.set_num_threads(2)

STEPS, BATCH = 3, 8


def _randomize(net, rng):
    for name, p in net.collect_params().items():
        if name.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "bias")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
        elif name.endswith("gamma"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))


def _setup(seed=0):
    """The JAX net with random BatchNorm state, and the global batches:
    each quarter of a batch has its own mean."""
    rng = np.random.RandomState(seed)
    jnet = dense_bn_dense(jmx)
    # The Dense weights come from the JAX package's RNG: seed it from the
    # test's own seed, not the session's.
    jmx.random.seed(seed)
    jnet.initialize()
    with jmx.autograd.pause():
        jnet(jmx.nd.array(rng.rand(BATCH, 4).astype(np.float32)))
    _randomize(jnet, rng)
    shift = np.repeat(np.arange(4, dtype=np.float32) * 1.5, BATCH // 4)
    xs = (rng.rand(STEPS, BATCH, 4).astype(np.float32) * 3 - 1
          + shift[None, :, None])
    ys = rng.randint(0, 2, (STEPS, BATCH)).astype(np.float32)
    return jnet, xs, ys


def _jax_run(jnet, xs, ys, n, deterministic=False):
    """(losses, {relative name: array} per kind) of the JAX step."""
    step = JTrainStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(OPT), mesh=jmake_mesh(
                          {"dp": n}, devices=jax.devices()[:n]),
                      deterministic_reduction=deterministic)
    losses = np.array([float(jax.device_get(step(x, y)))
                       for x, y in zip(xs, ys)], np.float32)
    params, opt_state, aux = step.state_to_host()
    rel = relative_names(list(params) + list(aux), jnet.prefix)
    state = {}
    for n_, v in params.items():
        state["p:" + rel[n_]] = np.asarray(v)
        state["m:" + rel[n_]] = np.asarray(opt_state[n_][0])
    for n_, v in aux.items():
        state["a:" + rel[n_]] = np.asarray(v)
    return losses, state


_RUNS = {}


def _port_run(n, tmp_path_factory):
    """The ranks' outputs ({tag:...} per rank) and the JAX net/batches,
    one launch per world size."""
    if n not in _RUNS:
        jnet, xs, ys = _setup()
        d = tmp_path_factory.mktemp("dp%d" % n)
        weights = {"w:" + k: p.data().asnumpy()
                   for k, p in jnet.collect_params().items()}
        np.savez(d / "data.npz", x=xs, y=ys, prefix=jnet.prefix, **weights)
        launch(n, 0, "spmd_trainstep", d, data=d / "data.npz")
        outs = [dict(np.load(d / ("trainstep_r%d.npz" % r)))
                for r in range(n)]
        _RUNS[n] = (outs, jnet, xs, ys, weights)
    return _RUNS[n]


def _state_of(out, tag):
    pre = tag + ":"
    return {k[len(pre):]: v for k, v in out.items()
            if k.startswith(pre) and k[len(pre):len(pre) + 2] in
            ("p:", "m:", "a:")}


def _hold(got_losses, got_state, want_losses, want_state):
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-6)
    assert sorted(got_state) == sorted(want_state)
    for name, w in want_state.items():
        np.testing.assert_allclose(
            got_state[name], w, rtol=1e-5,
            atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_jax_dp_mesh(n, tmp_path_factory):
    outs, jnet, xs, ys, _ = _port_run(n, tmp_path_factory)
    want_losses, want_state = _jax_run(jnet, xs, ys, n)
    for out in outs:
        _hold(out["dp:loss"], _state_of(out, "dp"), want_losses,
              want_state)
        assert int(out["dp:rng_generators"]) == 0
    # Replicated: every rank holds the same bits.
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith("dp:"):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_per_rank_batchnorm_is_not_the_jax_step(n, tmp_path_factory):
    """BatchNorm over each rank's own rows (DDP's) misses the JAX step
    by far more than the tolerance: the slices' means differ."""
    outs, jnet, xs, ys, _ = _port_run(n, tmp_path_factory)
    want_losses, _ = _jax_run(jnet, xs, ys, n)
    got = outs[0]["perrank:loss"]
    assert np.abs(got[1:] - want_losses[1:]).max() > \
        100 * (1e-6 + 1e-5 * np.abs(want_losses[1:]).max())


@pytest.mark.parametrize("n", [2, 4])
def test_deterministic_reduction_matches_jax_and_the_ordered_sum(
        n, tmp_path_factory):
    outs, jnet, xs, ys, weights = _port_run(n, tmp_path_factory)
    want_losses, want_state = _jax_run(jnet, xs, ys, n, deterministic=True)
    for out in outs:
        _hold(out["det:loss"], _state_of(out, "det"), want_losses,
              want_state)
    # Bit for bit: the same per-shard gradients and statistics, summed in
    # ascending rank order and divided by n, in this one process.
    with mx.cpu():
        net = dense_bn_dense(mx)
        net.initialize(ctx=mx.cpu())
    params_from_numpy(net, {k[2:]: v for k, v in weights.items()},
                      prefix=jnet.prefix)
    step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=make_mesh({"dp": 1},
                                               devices=[mx.cpu()]))
    per = BATCH // n
    losses = []
    for x, y in zip(xs, ys):
        if not step._materialized:
            step._materialize(torch.from_numpy(x[:1]))
        shards = [step._loss_and_grads(torch.from_numpy(x[r * per:(r + 1)
                                                          * per]),
                                       torch.from_numpy(y[r * per:(r + 1)
                                                          * per]))
                  for r in range(n)]

        def ordered(parts):
            acc = parts[0]
            for t in parts[1:]:
                acc = acc + t
            return acc / n

        loss = ordered([s[0] for s in shards])
        grads = {k: ordered([s[1][k] for s in shards]) for k in shards[0][1]}
        aux = {k: ordered([s[2][k] for s in shards]) for k in shards[0][2]}
        step._apply_update(grads, aux, step.num_update + 1)
        losses.append(float(loss))
    want = {}
    params, opt_state, aux = step.state_to_host()
    rel = relative_names(list(params) + list(aux), net.prefix)
    for k, v in params.items():
        want["p:" + rel[k]] = v
        want["m:" + rel[k]] = opt_state[k][0]
    for k, v in aux.items():
        want["a:" + rel[k]] = v
    for out in outs:
        np.testing.assert_array_equal(out["det:loss"],
                                      np.array(losses, np.float32))
        got = _state_of(out, "det")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_world_size_one_is_the_single_device_step_bit_for_bit(
        tmp_path_factory):
    outs, jnet, xs, ys, _ = _port_run(1, tmp_path_factory)
    out = outs[0]
    for tag in ("dp", "det"):
        np.testing.assert_array_equal(out[tag + ":loss"], out["single:loss"])
        single = _state_of(out, "single")
        got = _state_of(out, tag)
        assert sorted(got) == sorted(single)
        for k in single:
            np.testing.assert_array_equal(got[k], single[k], err_msg=k)
    want_losses, want_state = _jax_run(jnet, xs, ys, 1)
    _hold(out["dp:loss"], _state_of(out, "dp"), want_losses, want_state)


def test_tp_axis_names_item_7b():
    # A one-device mesh whose axis sizes multiply to 2 is inconsistent;
    # a tp axis (tests/test_torch_tp.py trains over one) still refuses
    # deterministic_reduction, as the JAX package does.
    mesh = mx.parallel.Mesh([mx.cpu()], ("dp", "tp"), (1, 2))
    with pytest.raises(ValueError,
                       match=r"\{'dp': 1, 'tp': 2\} over 1 device.*to 2"):
        TrainStep(dense_bn_dense(mx), mx.gluon.loss.L2Loss(), mesh=mesh)
    ranks = mx.parallel.Mesh([mx.cpu()], ("dp", "tp"), (1, 2), ranks=[0, 1])
    with pytest.raises(ValueError, match="dp-only"):
        TrainStep(dense_bn_dense(mx), mx.gluon.loss.L2Loss(), mesh=ranks,
                  deterministic_reduction=True)
