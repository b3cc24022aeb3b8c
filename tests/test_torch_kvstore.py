"""The port's single-process kvstore and gradient-compression codec
against the JAX package's.

Stores: ``local`` and ``device`` push (a list of values is summed),
pull, pushpull, an optimizer as the updater, and optimizer-state
checkpoints, on the same numpy values in both packages (sums of float32
values in the same order: equal; optimizer updates: 8 float32 ulps of
the largest entry). The codec: packed bytes, dequantized values and
error-feedback residuals over three pushes, equal to the JAX numpy
codec's bit for bit. ``dist_*`` stores and row-sparse pulls raise with
their ROADMAP item.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gradient_compression import GradientCompression as JGC

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gradient_compression import GradientCompression

torch.set_num_threads(2)

EPS32 = 2.0 ** -23


def _vals(seed, n=3, shape=(4, 5)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["local", "device"])
def test_push_list_sums_and_pull_matches_jax(kind):
    init, *parts = _vals(0, 4)
    jkv, tkv = jmx.kv.create(kind), mx.kv.create(kind)
    assert tkv.type == jkv.type == kind
    jkv.init(3, jmx.nd.array(init))
    jkv.push(3, [jmx.nd.array(p) for p in parts])
    jout = jmx.nd.zeros(init.shape)
    jkv.pull(3, out=jout)
    with mx.cpu():
        tkv.init(3, mx.nd.array(init))
        tkv.push(3, [mx.nd.array(p) for p in parts])
        outs = [mx.nd.zeros(init.shape), mx.nd.zeros(init.shape)]
    tkv.pull(3, out=outs)
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), jout.asnumpy())
    assert tkv.contains(3) and not tkv.contains(4)


def test_multi_key_push_pull_and_pushpull():
    a, b, c, d = _vals(1, 4)
    with mx.cpu():
        kv = mx.kv.create("device")
        kv.init(["a", "b"], [mx.nd.array(a), mx.nd.array(b)])
        kv.push(["a", "b"], [[mx.nd.array(c), mx.nd.array(d)],
                             mx.nd.array(a)])
        oa, ob = mx.nd.zeros(a.shape), mx.nd.zeros(b.shape)
        kv.pull(["a", "b"], out=[oa, ob])
        np.testing.assert_array_equal(oa.asnumpy(), c + d)
        np.testing.assert_array_equal(ob.asnumpy(), a)
        v = mx.nd.array(b)
        kv.pushpull("a", v)
        np.testing.assert_array_equal(v.asnumpy(), b)
        out = mx.nd.zeros(b.shape)
        kv.pushpull("b", [mx.nd.array(c), mx.nd.array(d)], out=out)
        np.testing.assert_array_equal(out.asnumpy(), c + d)
        handle = kv.pull_async("b", out=oa)
        handle.wait()
        assert handle.done() and handle.inline
        np.testing.assert_array_equal(oa.asnumpy(), c + d)


def test_assign_does_not_alias_the_pushed_array():
    a, b = _vals(2, 2)
    with mx.cpu():
        kv = mx.kv.create("local")
        kv.init(0, mx.nd.array(a))
        g = mx.nd.array(b)
        kv.push(0, g)
        g[:] = 0
        out = mx.nd.zeros(a.shape)
        kv.pull(0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), b)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_set_optimizer_updates_on_push_as_in_jax(optimizer, tmp_path):
    """Three pushes of two summed values through the optimizer (8 ulps of
    the largest entry); the states then survive a save/load round trip
    into a fresh store, equal."""
    w, *grads = _vals(3, 4)
    kw = {"learning_rate": 0.1, "wd": 0.01}
    if optimizer == "sgd":
        kw["momentum"] = 0.9
    jkv, tkv = jmx.kv.create("device"), mx.kv.create("device")
    jkv.set_optimizer(jmx.optimizer.create(optimizer, **kw))
    tkv.set_optimizer(mx.optimizer.create(optimizer, **kw))
    jkv.init(0, jmx.nd.array(w))
    with mx.cpu():
        tkv.init(0, mx.nd.array(w))
    for g in grads:
        jkv.push(0, [jmx.nd.array(g), jmx.nd.array(g * 0.5)])
        with mx.cpu():
            tkv.push(0, [mx.nd.array(g), mx.nd.array(g * 0.5)])
    jout = jmx.nd.zeros(w.shape)
    tout = mx.nd.zeros(w.shape, ctx=mx.cpu())
    jkv.pull(0, out=jout)
    tkv.pull(0, out=tout)
    want = jout.asnumpy()
    np.testing.assert_allclose(tout.asnumpy(), want, rtol=0,
                               atol=8 * EPS32 * np.abs(want).max())
    path = str(tmp_path / "kv.states")
    tkv.save_optimizer_states(path)
    tkv2 = mx.kv.create("device")
    tkv2.set_optimizer(mx.optimizer.create(optimizer, **kw))
    with mx.cpu():
        tkv2.init(0, mx.nd.array(w))
    tkv2.load_optimizer_states(path)
    a, b = tkv._updater.states[0], tkv2._updater.states[0]
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())


def test_optimizer_states_land_on_the_store_context(tmp_path):
    w, g = _vals(4, 2)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create("sgd", momentum=0.9))
    with mx.cpu():
        kv.init("w", mx.nd.array(w))
        kv.push("w", mx.nd.array(g))
    path = str(tmp_path / "s")
    kv.save_optimizer_states(path, dump_optimizer=True)
    kv2 = mx.kv.create("local")
    kv2.set_optimizer(mx.optimizer.create("sgd"))
    with mx.cpu():
        kv2.init("w", mx.nd.array(w))
    kv2.load_optimizer_states(path)       # outside `with mx.cpu()`
    assert kv2._updater.states["w"].context == mx.cpu()
    assert kv2._updater.optimizer.momentum == 0.9


@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_compression_codec_matches_jax_with_error_feedback(kind):
    params = {"type": kind, "threshold": 0.6}
    jgc, tgc = JGC(params), GradientCompression(params)
    assert tgc.get_params() == jgc.get_params()
    for step, g in enumerate(_vals(5, 3, (7, 9))):
        jpacked, jmeta = jgc.compress("k", g)
        tpacked, tmeta = tgc.compress("k", torch.from_numpy(g))
        assert bytes(tpacked.numpy().tobytes()) == jpacked, step
        assert tmeta["shape"] == tuple(jmeta["shape"])
        np.testing.assert_array_equal(tgc._residual["k"].numpy(),
                                      jgc._residual["k"])
        want = JGC.decompress(jpacked, jmeta)
        np.testing.assert_array_equal(
            GradientCompression.decompress(tpacked, tmeta).numpy(), want)
        np.testing.assert_array_equal(
            GradientCompression.decompress(jpacked, jmeta).numpy(), want)


def test_compression_params_are_stored_and_validated():
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    assert kv._compression_params == {"type": "2bit", "threshold": 0.5}
    with pytest.raises(ValueError):
        GradientCompression({"type": "3bit"})
    with pytest.raises(ValueError):
        GradientCompression({"threshold": 0})


@pytest.mark.parametrize("name", ["dist_sync", "dist_async",
                                  "dist_device_sync"])
def test_dist_stores_name_the_roadmap(name, monkeypatch, tmp_path):
    # create() gives the parameter-server store now: a scheduler and a
    # server of this process (threads) serve one worker, whose sparse
    # paths name their roadmap item. tests/test_torch_kvstore_dist.py
    # runs the stores across processes.
    import threading

    from mxnet_tpu_torch.kvstore_server import KVStoreServer, Scheduler
    from mxnet_tpu_torch.parallel.launch import free_port

    port = free_port()
    for k, v in (("DMLC_PS_ROOT_URI", "127.0.0.1"),
                 ("DMLC_PS_ROOT_PORT", str(port)),
                 ("DMLC_NUM_WORKER", "1"), ("DMLC_NUM_SERVER", "1")):
        monkeypatch.setenv(k, v)
    sched = Scheduler(1, 1, host="127.0.0.1", port=port)
    threads = [threading.Thread(target=sched.run, daemon=True),
               threading.Thread(target=KVStoreServer(
                   ("127.0.0.1", port), num_workers=1).run, daemon=True)]
    for t in threads:
        t.start()
    kv = mx.kv.create(name)
    try:
        assert kv.type == name and kv.num_workers == 1 and kv.rank == 0
        with mx.cpu():
            kv.init("w", mx.nd.ones((2,)))
            out = mx.nd.zeros((2,))
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out.asnumpy(), np.ones(2))
        with pytest.raises(NotImplementedError, match="Queue 1 item 11c"):
            kv.row_sparse_pull("w", out=out, row_ids=out)
        # The server's profiler answers every command: dumps, and the
        # device trace's (a CPU trace in a server).
        assert isinstance(kv.server_profiler_command("dumps")[0], str)
        trace = str(tmp_path / "server_trace.json")
        for sub, arg in (("set_config", {"filename": trace}),
                         ("set_state", "run"), ("pause", None),
                         ("resume", None), ("dump", None)):
            kv.server_profiler_command(sub, arg)
        with open(trace) as f:
            assert "traceEvents" in json.load(f)
    finally:
        kv.close()
    for t in threads:
        t.join(timeout=30)


def test_unknown_store_and_row_sparse_pull_raise():
    with pytest.raises(ValueError):
        mx.kv.create("nope")
    kv = mx.kv.create("local")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        kv.row_sparse_pull(0, out=None, row_ids=None)
