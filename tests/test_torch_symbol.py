"""mxnet_tpu_torch.symbol against the JAX package's symbol.py.

- Graphs built through the same calls with explicit names (and a fresh
  NameManager for the auto-named nodes) serialize to the same
  ``tojson()`` string in both packages.
- A graph file written by the JAX package loads in the port and
  serializes back to the same string.
- ``infer_shape`` gives the same argument, output and aux shapes for
  every op on ResNet's path (exact: shapes are integers), the port
  running each op on ``meta`` tensors.
- list_arguments/outputs/auxiliary_states, get_internals, indexing,
  attributes and AttrScope agree.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(2)


def _convnet(F):
    data = F.sym.var("data")
    x = F.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          no_bias=True, name="conv")
    x = F.sym.BatchNorm(x, fix_gamma=False, eps=1e-5, name="bn")
    x = F.sym.Activation(x, act_type="relu", name="relu")
    x = F.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool")
    x = F.sym.flatten(x, name="flat")
    x = F.sym.FullyConnected(x, num_hidden=5, name="fc")
    return F.sym.SoftmaxOutput(x, name="softmax")


def _arith(F):
    a, b = F.sym.var("a"), F.sym.var("b", shape=(2, 3), lr_mult=2.0)
    c = (a + b) * 2.0 - b / 3.0
    d = 1.0 - c
    e = (d ** 2.0) + (a > 0.5) + (a <= b) + 3.0 / (b + 1.0)
    return F.sym.Group([e, -c, F.sym.Activation(a, act_type="tanh",
                                                name="t")])


def _resnet_unit(F):
    data = F.sym.var("data")
    y = F.sym.Convolution(data, kernel=(1, 1), num_filter=8, no_bias=True,
                          name="c1")
    y = F.sym.BatchNorm(y, fix_gamma=False, name="b1")
    y = F.sym.Activation(y, act_type="relu", name="r1")
    z = F.sym.Convolution(data, kernel=(1, 1), num_filter=8, stride=(1, 1),
                          name="down")
    out = F.sym.Activation(y + z, act_type="relu", name="r2")
    out = F.sym.Pooling(out, kernel=(1, 1), global_pool=True,
                        pool_type="avg", name="gap")
    return F.sym.FullyConnected(out, num_hidden=3, name="head")


GRAPHS = {"convnet": _convnet, "arith": _arith, "resnet_unit": _resnet_unit}


def _both(build):
    with jmx.name.NameManager():
        j = build(jmx)
    with mx.name.NameManager():
        p = build(mx)
    return j, p


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tojson_is_identical(graph):
    j, p = _both(GRAPHS[graph])
    assert p.tojson() == j.tojson()
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.list_outputs() == j.list_outputs()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_jax_graph_file_loads_in_port(graph, tmp_path):
    j, _ = _both(GRAPHS[graph])
    fname = str(tmp_path / "g-symbol.json")
    j.save(fname)
    p = mx.sym.load(fname)
    assert p.tojson() == j.tojson()
    assert p.list_arguments() == j.list_arguments()
    # and the port's file loads in the JAX package
    p.save(str(tmp_path / "p-symbol.json"))
    assert jmx.sym.load(str(tmp_path / "p-symbol.json")).tojson() == \
        j.tojson()


def _single(F, op, shape):
    data = F.sym.var("data")
    return {
        "conv": lambda: F.sym.Convolution(data, kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), num_filter=6,
                                          name="op"),
        "conv_group": lambda: F.sym.Convolution(data, kernel=(1, 1),
                                                num_filter=4, num_group=2,
                                                no_bias=True, name="op"),
        "bn": lambda: F.sym.BatchNorm(data, name="op"),
        "relu": lambda: F.sym.Activation(data, act_type="relu", name="op"),
        "maxpool": lambda: F.sym.Pooling(data, kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1), pool_type="max",
                                         name="op"),
        "avgpool_full": lambda: F.sym.Pooling(
            data, kernel=(3, 3), stride=(2, 2), pool_type="avg",
            pooling_convention="full", name="op"),
        "gap": lambda: F.sym.Pooling(data, kernel=(1, 1), global_pool=True,
                                     pool_type="avg", name="op"),
        "fc": lambda: F.sym.FullyConnected(data, num_hidden=7, name="op"),
        "fc_noflat": lambda: F.sym.FullyConnected(data, num_hidden=7,
                                                  flatten=False, name="op"),
        "flatten": lambda: F.sym.Flatten(data, name="op"),
        "plus": lambda: data + data,
        "softmax_out": lambda: F.sym.SoftmaxOutput(data, name="op"),
    }[op]()


@pytest.mark.parametrize("op", [
    "conv", "conv_group", "bn", "relu", "maxpool", "avgpool_full", "gap",
    "fc", "fc_noflat", "flatten", "plus", "softmax_out"])
def test_infer_shape_matches_on_resnet_ops(op):
    shape = (2, 4, 9, 11)
    with jmx.name.NameManager():
        j = _single(jmx, op, shape)
    with mx.name.NameManager():
        p = _single(mx, op, shape)
    got = p.infer_shape(data=shape)
    want = j.infer_shape(data=shape)
    assert [list(map(tuple, g)) for g in got] == \
        [list(map(tuple, w)) for w in want]


def test_infer_shape_whole_convnet_and_partial():
    j, p = _both(_convnet)
    assert p.infer_shape(data=(3, 2, 8, 8)) == \
        tuple([list(map(tuple, w)) for w in j.infer_shape(data=(3, 2, 8, 8))])
    with pytest.raises(MXNetError, match="missing input shapes"):
        p.infer_shape()
    assert p.infer_shape_partial() == (None, None, None)
    assert p.infer_type()[0] == [np.float32] * len(p.list_arguments())


def test_internals_indexing_and_attrs():
    j, p = _both(_convnet)
    assert p.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert p.get_internals()["relu_output"].name == "relu"
    grp = mx.sym.Group([p, p.get_internals()["fc_output"]])
    assert len(grp) == 2 and grp[1].name == "fc"
    with mx.attribute.AttrScope(ctx_group="dev1"):
        v = mx.sym.var("w", lr_mult=0.5, init="zeros")
        n = mx.sym.FullyConnected(v, num_hidden=2, name="f")
    with jmx.attribute.AttrScope(ctx_group="dev1"):
        jv = jmx.sym.var("w", lr_mult=0.5, init="zeros")
        jn = jmx.sym.FullyConnected(jv, num_hidden=2, name="f")
    assert n.attr("ctx_group") == "dev1"
    assert n.attr_dict() == jn.attr_dict()
    assert n.tojson() == jn.tojson()


def test_unported_ops_raise():
    data = mx.sym.var("data")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        mx.sym.LayerNorm(data)
    with pytest.raises(NotImplementedError, match="symbol_contrib"):
        mx.sym.contrib
    with pytest.raises(AttributeError):
        mx.sym.NoSuchOp(data)
