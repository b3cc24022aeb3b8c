"""mxnet_tpu_torch.executor against the JAX package's Executor.

A small convnet with BatchNorm (conv -> BN -> relu -> max pool -> fc)
bound in both packages to the same numpy arrays: forward in eval and
train mode (BatchNorm's moving statistics written to the aux arrays in
train mode), and backward with grad_req write/add/null and explicit
out_grads. SoftmaxOutput's own gradient (grad_scale, ignore_label,
normalization, multi_output) the same way. fp32 within rtol 1e-5 /
atol 1e-6. Then the Executor's utilities (reshape, copy_params_from,
the dicts, the monitor callback), group2ctx, auto-partition at bind
from MXNET_SUBGRAPH_BACKEND, and the error of a fragment function that
returns too few outputs.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _net(F):
    data = F.sym.var("data")
    x = F.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="conv")
    x = F.sym.BatchNorm(x, fix_gamma=False, eps=1e-5, momentum=0.8,
                        name="bn")
    x = F.sym.Activation(x, act_type="relu", name="relu")
    x = F.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool")
    return F.sym.FullyConnected(x, num_hidden=5, name="fc")


DSHAPE = (3, 2, 6, 6)


def _arrays(sym, seed):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=DSHAPE)
    args = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(pkg, sym, args, aux, grad_req, grads=None):
    nd = pkg.nd
    ctx = pkg.cpu()
    kw = {"ctx": ctx} if pkg is jmx else {}
    with ctx:
        return sym.bind(
            args={k: nd.array(v) for k, v in args.items()},
            args_grad=None if grads is None else
            {k: nd.array(v) for k, v in grads.items()},
            grad_req=grad_req,
            aux_states={k: nd.array(v) for k, v in aux.items()}, **kw)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("is_train", [False, True])
def test_forward_and_aux_writes_match(is_train):
    jsym, psym = _net(jmx), _net(mx)
    args, aux = _arrays(jsym, 0)
    jex = _bind(jmx, jsym, args, aux, "null")
    pex = _bind(mx, psym, args, aux, "null")
    want = jex.forward(is_train=is_train)[0].asnumpy()
    got = pex.forward(is_train=is_train)[0].asnumpy()
    _close(got, want)
    for n in psym.list_auxiliary_states():
        _close(pex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy())
    if is_train:
        assert not np.allclose(pex.aux_dict["bn_moving_mean"].asnumpy(),
                               aux["bn_moving_mean"])
    # fed values are written into the bound arrays in place
    x = np.random.RandomState(9).randn(*DSHAPE).astype(np.float32)
    data = pex.arg_dict["data"]
    _close(pex.forward(is_train=False, data=x)[0].asnumpy(),
           jex.forward(is_train=False, data=jmx.nd.array(x))[0].asnumpy())
    assert pex.arg_dict["data"] is data
    np.testing.assert_array_equal(data.asnumpy(), x)


@pytest.mark.parametrize("forward_train", [True, False])
def test_backward_with_grad_req_and_out_grads(forward_train):
    jsym, psym = _net(jmx), _net(mx)
    args, aux = _arrays(jsym, 1)
    rng = np.random.RandomState(2)
    grads = {n: rng.randn(*v.shape).astype(np.float32)
             for n, v in args.items()}
    req = {n: "write" for n in args}
    req.update(data="null", bn_gamma="add", fc_bias="add", conv_bias="null")
    jex = _bind(jmx, jsym, args, aux, req, grads)
    pex = _bind(mx, psym, args, aux, req, grads)
    head = rng.randn(DSHAPE[0], 5).astype(np.float32)
    jex.forward(is_train=forward_train)
    pex.forward(is_train=forward_train)
    jex.backward(out_grads=[jmx.nd.array(head)])
    with mx.cpu():
        pex.backward(out_grads=[mx.nd.array(head)])
    for n in args:
        g = pex.grad_dict[n].asnumpy()
        _close(g, jex.grad_dict[n].asnumpy())
        if req[n] == "null":
            np.testing.assert_array_equal(g, grads[n])
        else:
            assert not np.allclose(g, grads[n]), n


def _softmax_net(F, **attrs):
    data = F.sym.var("data")
    x = F.sym.FullyConnected(data, num_hidden=4, name="fc")
    return F.sym.SoftmaxOutput(x, name="sm", **attrs)


@pytest.mark.parametrize("attrs", [
    {}, {"grad_scale": 0.5, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"smooth_alpha": 0.1}])
def test_softmax_output_gradient_matches(attrs):
    jsym, psym = _softmax_net(jmx, **attrs), _softmax_net(mx, **attrs)
    rng = np.random.RandomState(3)
    args = {"data": rng.randn(6, 3).astype(np.float32),
            "fc_weight": rng.randn(4, 3).astype(np.float32),
            "fc_bias": rng.randn(4).astype(np.float32),
            "sm_label": np.array([0, 1, 2, 3, 2, 1], np.float32)}
    jex = _bind(jmx, jsym, args, {}, "write")
    pex = _bind(mx, psym, args, {}, "write")
    _close(pex.forward(is_train=True)[0].asnumpy(),
           jex.forward(is_train=True)[0].asnumpy())
    jex.backward()
    pex.backward()
    for n in args:
        _close(pex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy())


def test_softmax_output_multi_output_gradient():
    def build(F):
        return F.sym.SoftmaxOutput(F.sym.var("data"), multi_output=True,
                                   name="sm")

    rng = np.random.RandomState(4)
    args = {"data": rng.randn(2, 3, 4).astype(np.float32),
            "sm_label": rng.randint(0, 3, (2, 4)).astype(np.float32)}
    jsym, psym = build(jmx), build(mx)
    assert psym.infer_shape(data=(2, 3, 4)) == \
        tuple([list(map(tuple, w)) for w in
               jsym.infer_shape(data=(2, 3, 4))])
    jex = _bind(jmx, jsym, args, {}, "write")
    pex = _bind(mx, psym, args, {}, "write")
    jex.forward(is_train=True)
    pex.forward(is_train=True)
    jex.backward()
    pex.backward()
    _close(pex.grad_dict["data"].asnumpy(), jex.grad_dict["data"].asnumpy())


def test_simple_bind_reshape_and_utilities():
    psym = _net(mx)
    jsym = _net(jmx)
    args, aux = _arrays(jsym, 5)
    with mx.cpu():
        ex = psym.simple_bind(mx.cpu(), grad_req="null", data=DSHAPE)
    ex.copy_params_from({k: v for k, v in args.items()}, aux)
    with pytest.raises(ValueError, match="not in the arguments"):
        ex.copy_params_from({"nope": args["data"]})
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    want = _bind(jmx, jsym, args, aux, "null").forward()[0].asnumpy()
    _close(ex.forward()[0].asnumpy(), want)
    assert seen == ["fc_output"]
    assert list(ex.output_dict) == ["fc_output"]
    assert "BatchNorm(bn)" in ex.debug_str()
    small = ex.reshape(data=(1,) + DSHAPE[1:])
    assert small.arg_dict["conv_weight"] is ex.arg_dict["conv_weight"]
    x = args["data"][:1]
    _close(small.forward(data=x)[0].asnumpy(), want[:1])
    fc = {k: v for k, v in _arrays(_softmax_net(jmx), 8)[0].items()
          if k != "sm_label"}
    jout = jmx.sym.FullyConnected(jmx.sym.var("data"), num_hidden=4,
                                  name="fc").eval(
        jmx.cpu(), **{k: jmx.nd.array(v) for k, v in fc.items()})
    with mx.cpu():
        out = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                    name="fc").eval(
            **{k: mx.nd.array(v) for k, v in fc.items()})
    _close(out[0].asnumpy(), jout[0].asnumpy())
    with pytest.raises(MXNetError, match="backward called before forward"):
        _bind(mx, psym, args, aux, "write").backward()


def test_group2ctx_only_on_the_executors_device():
    with mx.attribute.AttrScope(ctx_group="g1"):
        sym = _net(mx)
    args, aux = _arrays(_net(jmx), 6)
    with mx.cpu():
        arrays = {k: mx.nd.array(v) for k, v in args.items()}
        auxs = {k: mx.nd.array(v) for k, v in aux.items()}
        ex = sym.bind(mx.cpu(), args=arrays, aux_states=auxs,
                      grad_req="null", group2ctx={"g1": mx.cpu()})
        ex.forward()
        # A device this machine does not have (gpu(0) on the host)
        # raises at bind; placement itself is tested in
        # tests/test_torch_executor_groups.py.
        absent = mx.gpu(torch.cuda.device_count())
        with pytest.raises(RuntimeError, match="CUDA device"):
            sym.bind(mx.cpu(), args=arrays, aux_states=auxs,
                     grad_req="null", group2ctx={"g1": absent})
        with pytest.raises(MXNetError, match="no entry in group2ctx"):
            sym.bind(mx.cpu(), args=arrays, aux_states=auxs,
                     grad_req="null", group2ctx={"other": mx.cpu()})


class _Relu(subgraph.SubgraphProperty):
    inference_only = True

    def __init__(self, fn):
        self._fn = fn

    def select(self, node):
        return node._op == "Activation"

    def select_input(self, node, inp):
        return inp._op == "BatchNorm"

    def create_fn(self, sub_sym, arg_names):
        return self._fn


def test_auto_partition_at_bind(monkeypatch, caplog):
    sym = _net(mx)
    args, aux = _arrays(_net(jmx), 7)
    calls = []

    def fused(x, g, b, m, v):
        calls.append(x.shape)
        return torch.relu(torch.nn.functional.batch_norm(
            x, m, v, g, b, False, 0.0, 1e-5))

    subgraph.register_backend("test_torch_executor_bn_relu", _Relu(fused))
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND",
                       "test_torch_executor_bn_relu")
    ex = _bind(mx, sym, args, aux, "null")
    assert any(n._op == "_subgraph" for n in ex._symbol._topo())
    got = ex.forward()[0].asnumpy()
    assert calls == [(3, 4, 6, 6)]
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "no_such_backend")
    with caplog.at_level(logging.WARNING):
        plain = _bind(mx, sym, args, aux, "null")
    assert "not a registered subgraph backend" in caplog.text
    assert not any(n._op == "_subgraph" for n in plain._symbol._topo())
    _close(got, plain.forward()[0].asnumpy())


def test_fragment_fn_with_too_few_outputs_raises():
    data = mx.sym.var("data")
    bn = mx.sym.BatchNorm(data, name="bn")
    act = mx.sym.Activation(bn, act_type="relu", name="act")
    both = act + bn  # bn is also read outside: a 2-output fragment
    prop = _Relu(lambda *xs: xs[0])
    psym = subgraph.partition(both, prop)
    sub = [n for n in psym._topo() if n._op == "_subgraph"]
    assert len(sub) == 1 and sub[0]._num_outputs == 2
    with mx.cpu():
        ex = psym.simple_bind(mx.cpu(), grad_req="null", data=(2, 3))
    with pytest.raises(ValueError, match="returned 1 value"):
        ex.forward()
