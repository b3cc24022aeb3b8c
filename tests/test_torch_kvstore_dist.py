"""The dist_* kvstores across processes: scheduler, servers, workers.

Counterparts of tests/test_kvstore_dist.py for the port. Each case runs
tests/torch_dist_prog.py through the port's launcher (free ports, a
timeout of at most 120 s, two threads a process): a scheduler, two
servers and two workers on the host, with ``MXNET_KVSTORE_BIGARRAY_
BOUND`` lowered so that one key is split across both servers. The
workers check closed-form values (tests/dist_prog.py's: the servers'
sum without an optimizer, the Test optimizer's updates, a push merged
over two contexts, pushpull and pull_async, a float64 key bit for bit,
two-bit compression, the optimizer states round-trip) and exit 0.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx

from mxnet_tpu_torch.gluon.utils import relative_names

from torch_dist_prog import launch

torch.set_num_threads(2)

_ENV = {"MXNET_KVSTORE_BIGARRAY_BOUND": "4000"}


@pytest.mark.parametrize("kv_type", ["dist_sync", "dist_device_sync",
                                     "dist_async"])
def test_dist_stores_across_processes(kv_type, tmp_path):
    launch(2, 2, "kvstore", tmp_path, kv_type=kv_type, env=_ENV)


def test_dead_worker_is_detected_and_breaks_the_barrier(tmp_path):
    """Rank 1 dies without finalizing: rank 0 sees it in
    get_dead_nodes, and its next barrier raises instead of hanging."""
    from mxnet_tpu_torch.parallel.launch import launch_local
    import sys

    from torch_dist_prog import PROG

    codes, outs = launch_local(
        2, 1, [sys.executable, PROG, "--mode", "failure", "--out",
               str(tmp_path)],
        env_extra={"MXNET_TEST_OUT": str(tmp_path),
                   "MXNET_TPU_PS_HEARTBEAT": "1"},
        timeout=120, capture=True, fail_fast=False)
    assert codes == [0, 0], outs
    # Ranks follow the scheduler's registration order, not the launch
    # order: one of the two workers was rank 0.
    assert any("failure detection ok" in err for _, err in outs), outs


def test_dist_sync_trainer_matches_jax_trainer_on_two_contexts(tmp_path):
    """Two workers, each on its half of the global batch, through
    Trainer(kvstore="dist_sync") (SGD on the server), against the JAX
    package's single-process Trainer over kvstore="device" and two
    contexts fed the same global batch with split_and_load. Weights
    after 3 steps within rtol 1e-5 and atol 1e-4 of each tensor's
    largest magnitude (tests/test_torch_train_step.py's state
    tolerance)."""
    rng = np.random.RandomState(4)
    steps, batch = 3, 8
    xs = rng.randn(steps, batch, 4).astype(np.float32)
    ys = rng.randn(steps, batch, 2).astype(np.float32)
    ctxs = [jmx.cpu(0), jmx.cpu(1)]
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(8, in_units=4, activation="tanh"))
    net.add(jmx.gluon.nn.Dense(2, in_units=8))
    net.initialize(jmx.init.Xavier(), ctx=ctxs)
    weights = {"w:" + k: p.data(ctxs[0]).asnumpy()
               for k, p in net.collect_params().items()}
    np.savez(tmp_path / "data.npz", x=xs, y=ys, prefix=net.prefix,
             **weights)
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device")
    loss_fn = jmx.gluon.loss.L2Loss()
    for x, y in zip(xs, ys):
        xl = jmx.gluon.utils.split_and_load(jmx.nd.array(x), ctxs)
        yl = jmx.gluon.utils.split_and_load(jmx.nd.array(y), ctxs)
        with jmx.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xl, yl)]
        for l in losses:
            l.backward()
        tr.step(batch)
    jax.effects_barrier()
    params = net.collect_params()
    rel = relative_names(list(params.keys()), net.prefix)
    want = {rel[k]: p.data(ctxs[0]).asnumpy() for k, p in params.items()}
    launch(2, 1, "trainer", tmp_path, data=tmp_path / "data.npz")
    outs = [np.load(tmp_path / ("trainer_r%d.npz" % r)) for r in range(2)]
    for out in outs:
        assert sorted(k[2:] for k in out.files) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(
                out["p:" + name], w, rtol=1e-5,
                atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name in want:
        np.testing.assert_array_equal(outs[0]["p:" + name],
                                      outs[1]["p:" + name])


def test_dist_sync_module_over_contexts_matches_jax_module(tmp_path):
    """Two workers, each a Module over [cpu(0), cpu(1)] fit with
    kvstore="dist_sync" (its half of every global batch of 16 rows,
    the optimizer on the server), against the JAX package's Module over
    four contexts with kvstore="local" on the global batches: the same
    SGD-momentum update of the mean over 16 rows. Two batches; weights
    within the state tolerance above."""
    from mxnet_tpu.module import Module as JModule

    rng = np.random.RandomState(9)
    steps, batch = 2, 16
    xs = rng.randn(steps, batch, 6).astype(np.float32)
    ys = rng.randint(0, 3, (steps, batch)).astype(np.float32)
    shapes = {"fc1_weight": (16, 6), "fc1_bias": (16,),
              "fc2_weight": (3, 16), "fc2_bias": (3,)}
    arg = {k: (rng.randn(*s) * 0.3).astype(np.float32)
           for k, s in shapes.items()}
    np.savez(tmp_path / "data.npz", x=xs, y=ys,
             **{"w:" + k: v for k, v in arg.items()})
    data = jmx.sym.Variable("data")
    net = jmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = jmx.sym.SoftmaxOutput(net, name="softmax")
    ctxs = [jmx.cpu(i) for i in range(4)]
    mod = JModule(net, context=ctxs)
    mod.bind(data_shapes=[("data", (batch, 6))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: jmx.nd.array(v)
                                for k, v in arg.items()})
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    for x, y in zip(xs, ys):
        mod.forward(jmx.io.DataBatch(data=[jmx.nd.array(x)],
                                     label=[jmx.nd.array(y)]),
                    is_train=True)
        mod.backward()
        mod.update()
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    launch(2, 1, "module", tmp_path, data=tmp_path / "data.npz")
    outs = [np.load(tmp_path / ("module_r%d.npz" % r)) for r in range(2)]
    for out in outs:
        assert sorted(k[2:] for k in out.files) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(
                out["p:" + name], w, rtol=1e-5,
                atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name in want:
        np.testing.assert_array_equal(outs[0]["p:" + name],
                                      outs[1]["p:" + name])


def test_two_bit_compression_rides_the_overlapped_buckets(tmp_path):
    """A dist_sync Trainer with update_on_kvstore=False and 2-bit
    compression: the overlapped bucketed reduce compresses each bucket
    with its own error-feedback residual (kept across steps), and the
    two workers end with the same weights."""
    launch(2, 1, "overlap_compressed", tmp_path)
    w = [np.load(tmp_path / ("overlap_r%d.npz" % r))["w"] for r in range(2)]
    np.testing.assert_array_equal(w[0], w[1])
