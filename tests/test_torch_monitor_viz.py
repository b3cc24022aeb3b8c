"""``mx.monitor`` and ``mx.visualization`` of the port against the JAX
package's.

- ``Monitor.toc()`` over a small MLP ``Module`` trained on the same
  batches from the same ``arg_params``: the same (step, name) list in
  both packages, every statistic within rtol 1e-6 (atol 1e-7; two
  float32 GEMM summation orders); the default statistic is mean(|x|)
  of the output's host copy within rtol 1e-6, and ``toc_print`` prints
  one line per (step, name);
- ``print_summary``'s text the same line for line, and its total, for a
  LeNet and a ResNet-18 v1 symbol built with explicit names in both
  packages; ``plot_network``'s DOT text the same (the ``graphviz``
  object's source where that package is installed, the text itself
  where it is not).
"""
import re
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

torch.set_num_threads(2)

C = mx.cpu()
STAT_RTOL = 1e-6


def _mlp(m):
    data = m.sym.var("data")
    h = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = m.sym.Activation(h, act_type="relu", name="relu1")
    h = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(h, name="softmax")


def _mlp_params():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.normal(0, 0.3, (16, 8)).astype(np.float32),
            "fc1_bias": rng.normal(0, 0.1, (16,)).astype(np.float32),
            "fc2_weight": rng.normal(0, 0.3, (4, 16)).astype(np.float32),
            "fc2_bias": np.zeros((4,), np.float32)}


def _monitored_run(m, batches, mon, **ctx):
    mod = m.mod.Module(_mlp(m), **({"context": ctx["ctx"]} if ctx else {}))
    it = m.io.NDArrayIter(batches[0], batches[1], batch_size=8, **ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: m.nd.array(v, **ctx)
                                for k, v in _mlp_params().items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mod.install_monitor(mon)
    got = []
    for batch in it:
        mon.tic()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        got.append(mon.toc())
    return got


def _batches():
    rng = np.random.RandomState(1)
    return (rng.normal(size=(32, 8)).astype(np.float32),
            rng.randint(0, 4, 32).astype(np.float32))


def _stat(s):
    return np.array([float(x) for x in s.strip("[]").split()])


@pytest.mark.parametrize("interval,pattern,sort", [
    (1, ".*", False), (2, "softmax.*", True), (3, "nothing", False)])
def test_monitor_toc_matches_the_jax_package(interval, pattern, sort):
    batches = _batches()
    tmon = mx.monitor.Monitor(interval, pattern=pattern, sort=sort)
    jmon = jmx.monitor.Monitor(interval, pattern=pattern, sort=sort)
    got = _monitored_run(mx, batches, tmon, ctx=C)
    want = _monitored_run(jmx, batches, jmon)
    assert [[(s, n) for s, n, _ in r] for r in got] == \
        [[(s, n) for s, n, _ in r] for r in want]
    reported = sum(len(r) for r in got)
    assert reported == (0 if pattern == "nothing" else
                        len(range(0, 4, interval)))
    for g, w in zip(got, want):
        for (_, _, gs), (_, _, ws) in zip(g, w):
            np.testing.assert_allclose(_stat(gs), _stat(ws),
                                       rtol=STAT_RTOL, atol=1e-7)


def test_monitor_stat_is_mean_abs_of_the_output_and_prints(capsys):
    """The default statistic is mean(|x|) of the output on its own
    context; ``toc_print`` prints one line per (step, name)."""
    seen = []

    def stat(x):
        seen.append(x.asnumpy())
        assert x.context == C
        return x.abs().mean()

    mon = mx.monitor.Monitor(1, stat_func=stat)
    rows = _monitored_run(mx, _batches(), mon, ctx=C)
    for (_, name, s), host in zip([r[0] for r in rows], seen):
        assert name == "softmax_output"
        np.testing.assert_allclose(_stat(s), np.abs(host).mean(),
                                   rtol=STAT_RTOL)
    mon.tic()
    mon.stat_helper("softmax_output", mx.nd.ones((2, 2), ctx=C))
    mon.toc_print()
    out = capsys.readouterr().out
    assert re.fullmatch(r"Batch: +5 +softmax_output \[1\.\]\n", out), out
    assert mon.toc() == []


def _lenet(m):
    data = m.sym.var("data")
    c1 = m.sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    a1 = m.sym.Activation(c1, act_type="tanh", name="tanh1")
    p1 = m.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                       name="pool1")
    c2 = m.sym.Convolution(p1, kernel=(5, 5), num_filter=50, name="conv2")
    a2 = m.sym.Activation(c2, act_type="tanh", name="tanh2")
    p2 = m.sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                       name="pool2")
    f = m.sym.Flatten(p2, name="flatten")
    f1 = m.sym.FullyConnected(f, num_hidden=500, name="fc1")
    a3 = m.sym.Activation(f1, act_type="tanh", name="tanh3")
    f2 = m.sym.FullyConnected(a3, num_hidden=10, name="fc2")
    return m.sym.SoftmaxOutput(f2, name="softmax")


def _conv_bn(m, x, filters, kernel, stride, pad, name, relu=True):
    x = m.sym.Convolution(x, kernel=kernel, stride=stride, pad=pad,
                          num_filter=filters, no_bias=True,
                          name=name + "_conv")
    x = m.sym.BatchNorm(x, fix_gamma=False, eps=1e-5, name=name + "_bn")
    return m.sym.Activation(x, act_type="relu", name=name + "_relu") \
        if relu else x


def _resnet18_v1(m, classes=1000):
    """ResNet-18 v1 (He et al. 2015, basic blocks 2-2-2-2) with every
    node named."""
    data = m.sym.var("data")
    x = _conv_bn(m, data, 64, (7, 7), (2, 2), (3, 3), "stem")
    x = m.sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="stem_pool")
    for stage, filters in enumerate((64, 128, 256, 512)):
        for unit in range(2):
            name = "stage%d_unit%d" % (stage + 1, unit + 1)
            stride = (2, 2) if stage > 0 and unit == 0 else (1, 1)
            y = _conv_bn(m, x, filters, (3, 3), stride, (1, 1), name + "_a")
            y = _conv_bn(m, y, filters, (3, 3), (1, 1), (1, 1), name + "_b",
                         relu=False)
            if stride != (1, 1):
                x = _conv_bn(m, x, filters, (1, 1), stride, (0, 0),
                             name + "_down", relu=False)
            x = m.sym.Activation(m.sym.elemwise_add(y, x, name=name + "_add"),
                                 act_type="relu", name=name + "_relu")
    x = m.sym.Pooling(x, pool_type="avg", global_pool=True, kernel=(7, 7),
                      name="global_pool")
    x = m.sym.Flatten(x, name="flatten")
    x = m.sym.FullyConnected(x, num_hidden=classes, name="fc")
    return m.sym.SoftmaxOutput(x, name="softmax")


NETS = {"lenet": (_lenet, (1, 1, 28, 28)),
        "resnet18_v1": (_resnet18_v1, (1, 3, 224, 224))}


@pytest.mark.parametrize("net", sorted(NETS))
def test_print_summary_is_the_jax_packages_line_for_line(net, capsys):
    build, shape = NETS[net]
    ttotal = mx.viz.print_summary(build(mx), shape={"data": shape})
    tout = capsys.readouterr().out
    jtotal = jmx.viz.print_summary(build(jmx), shape={"data": shape})
    jout = capsys.readouterr().out
    assert tout.splitlines() == jout.splitlines()
    assert ttotal == jtotal > 0
    assert "Total params: %d" % ttotal in tout
    # Without shapes the table still prints, with no parameter counts.
    assert mx.viz.print_summary(build(mx)) == 0
    tbare = capsys.readouterr().out
    assert jmx.viz.print_summary(build(jmx)) == 0
    assert tbare == capsys.readouterr().out


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("hide_weights", [True, False])
def test_plot_network_is_the_jax_packages(net, hide_weights, monkeypatch):
    build, _ = NETS[net]
    tplot = mx.visualization.plot_network(build(mx), title=net,
                                          hide_weights=hide_weights)
    jplot = jmx.visualization.plot_network(build(jmx), title=net,
                                           hide_weights=hide_weights)
    tdot = getattr(tplot, "source", tplot)
    assert tdot == getattr(jplot, "source", jplot)
    # Where graphviz is absent, the DOT text itself comes back.
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "graphviz", None)
        text = mx.visualization.plot_network(
            build(mx), title=net, hide_weights=hide_weights)
        assert text == jmx.visualization.plot_network(
            build(jmx), title=net, hide_weights=hide_weights)
    assert isinstance(text, str) and text.rstrip() == tdot.rstrip()
    assert tdot.startswith('digraph "%s" {' % net)
    labels = re.findall(r'label="([^"\\]*)', tdot)
    assert ("stem_conv_weight" in labels) != hide_weights or net == "lenet"
