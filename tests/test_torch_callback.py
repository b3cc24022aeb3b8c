"""Training callbacks of mxnet_tpu_torch against the JAX package's:
Speedometer and TelemetryCallback log lines and counters, do_checkpoint
files (byte-identical ``-symbol.json`` and ``.params``), the metric
loggers, the checkpoint-manager and Module callbacks, and the raises of
what waits for a later slice.
"""
import json
import logging
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

torch.set_num_threads(2)


def _param(epoch, nbatch, metric=None):
    return types.SimpleNamespace(epoch=epoch, nbatch=nbatch,
                                 eval_metric=metric, locals=None)


def _acc(pkg):
    m = pkg.metric.Accuracy()
    m.update([np.array([0, 1, 1], np.float32)],
             [np.array([[.9, .1], [.2, .8], [.6, .4]], np.float32)])
    return m


def test_speedometer_logs_rate_and_metric_per_window(caplog, monkeypatch):
    """Windows open at the first batch and close every `frequent`
    batches; the line carries samples/sec and the metric, then resets
    it (auto_reset). Time is pinned so both packages log the same."""
    lines = {}
    for pkg in (jmx, mx):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(pkg.callback.time, "time", lambda: next(clock))
        caplog.clear()
        metric = _acc(pkg)
        cb = pkg.callback.Speedometer(batch_size=8, frequent=2)
        with caplog.at_level(logging.INFO):
            for nbatch in range(5):
                cb(_param(0, nbatch, metric))
            cb(_param(1, 0, metric))        # new epoch: window restarts
        lines[pkg] = [r.getMessage() for r in caplog.records]
        assert metric.num_inst == 0
    assert lines[mx] == lines[jmx]
    assert len(lines[mx]) == 2 and "Speed: 32.00 samples/sec" in lines[mx][0]
    assert "accuracy=0.666667" in lines[mx][0]


def test_do_checkpoint_files_are_byte_identical(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    mean = rng.randn(3).astype(np.float32)
    blobs = {}
    for tag, pkg in (("jax", jmx), ("port", mx)):
        data = pkg.sym.var("data")
        net = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
        ctx = mx.cpu() if pkg is mx else None
        kw = {} if ctx is None else {"ctx": ctx}
        arg = {"fc_weight": pkg.nd.array(w, **kw),
               "fc_bias": pkg.nd.array(b, **kw)}
        aux = {"bn_moving_mean": pkg.nd.array(mean, **kw)}
        prefix = str(tmp_path / tag)
        cb = pkg.callback.do_checkpoint(prefix, period=2)
        for epoch in range(4):
            cb(epoch, net, arg, aux)
        assert not (tmp_path / ("%s-0001.params" % tag)).exists()
        blobs[tag] = [(tmp_path / ("%s-%04d.params" % (tag, e))).read_bytes()
                      for e in (2, 4)] + \
            [(tmp_path / ("%s-symbol.json" % tag)).read_bytes()]
    assert blobs["port"] == blobs["jax"]
    _, arg, aux = mx.model.load_checkpoint(str(tmp_path / "port"), 4,
                                           ctx=mx.cpu())
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), w)
    np.testing.assert_array_equal(aux["bn_moving_mean"].asnumpy(), mean)


def test_metric_loggers_match_jax(caplog):
    lines = {}
    for pkg in (jmx, mx):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pkg.callback.log_train_metric(2)(_param(3, 4, _acc(pkg)))
            pkg.callback.log_train_metric(2)(_param(3, 5, _acc(pkg)))
            pkg.callback.LogValidationMetricsCallback()(
                _param(3, 0, _acc(pkg)))
            pkg.callback.ProgressBar(total=10, length=20)(_param(0, 4))
        lines[pkg] = [r.getMessage() for r in caplog.records]
    assert lines[mx] == lines[jmx]
    assert len(lines[mx]) == 3


def test_telemetry_callback_feeds_the_port_registry():
    seen = []
    monitor = types.SimpleNamespace(
        observe_step=lambda dt, step: seen.append((dt, step)))
    ticks = []
    ticker = types.SimpleNamespace(tick=lambda: ticks.append(1))
    cb = mx.callback.TelemetryCallback(batch_size=4, frequent=0,
                                       monitor=monitor, slo=ticker)
    for nbatch in range(3):
        cb(_param(0, nbatch))
    text = mx.telemetry.render_prometheus()
    assert "mx_train_batches_total" in text
    assert "mx_train_samples_total" in text
    assert [s for _, s in seen] == [1, 2] and len(ticks) == 3


def test_module_checkpoint_and_manager_name_the_roadmap(tmp_path):
    """Since the checkpoint and Module slice, module_checkpoint and
    do_checkpoint(manager=) work (they raised naming ROADMAP Queue 1
    items 5 and 6 before): the manager path commits what the JAX
    package's commits, the same arrays under the same keys. A Module
    over several contexts still names its roadmap item (7)."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as ck

    arg = np.arange(4, dtype=np.float32)
    for pkg, mod, tag in ((jmx, jck, "jax"), (mx, ck, "port")):
        with pkg.cpu():
            sym = pkg.sym.Variable("data") * 2
            m = mod.CheckpointManager(str(tmp_path / tag))
            cb = pkg.callback.do_checkpoint("unused", manager=m)
            cb(0, sym, {"w": pkg.nd.array(arg)}, {})
            m.wait()
    manifests = [json.loads((tmp_path / tag / "step-00000001" /
                             "manifest.json").read_bytes())
                 for tag in ("jax", "port")]
    for m in manifests:
        # The symbol JSON (node naming differs between the packages)
        # comes first in the shard and moves the weight's offset.
        m["arrays"].pop("symbol")
        m["arrays"]["arg/w"]["chunks"][0].pop("offset")
    assert manifests[0] == manifests[1]
    with mx.cpu():
        sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax")
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 3))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        mx.callback.module_checkpoint(mod, str(tmp_path / "m"))(0)
        assert (tmp_path / "m-0001.params").exists()
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            mx.mod.Module(sym, context=[mx.cpu(0), mx.cpu(1)])
