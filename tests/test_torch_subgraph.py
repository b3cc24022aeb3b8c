"""mxnet_tpu_torch.subgraph against the JAX package's subgraph.py.

The four tests of tests/test_subgraph_nce.py:61-142, run through both
packages on the same numpy inputs: the same ``_subgraph`` nodes appear
(output counts and argument names), and the values match (fp32, rtol
1e-5 / atol 1e-5 as there; the fused relu through the port's rtc kernel
runs its plain version on the host, the JAX side its Pallas kernel in
interpret mode). Then ``examples/fused_bn_relu`` on ResNet-18 v1
(thumbnail): 8 fragments, one BatchNorm -> relu pair in each BasicBlockV1
body, and the partitioned graph on the host matches the JAX package's
unpartitioned Executor within rtol 1e-4 of the largest logit; and a
pair whose BatchNorm output is also read outside it: a two-output
fragment that still runs the fused function, within rtol 1e-5 / atol
1e-5 of the JAX package's unpartitioned Executor.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import subgraph as jsubgraph
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

torch.set_num_threads(2)


def _dense_relu_sym(F):
    data = F.sym.var("data")
    fc = F.sym.FullyConnected(data, num_hidden=8, name="fc")
    act = F.sym.Activation(fc, act_type="relu", name="act")
    return F.sym.FullyConnected(act, num_hidden=3, name="out")


def _fuse_dense_relu(base):
    class FuseDenseRelu(base):
        def __init__(self, fused=None):
            self.calls = []
            self._fused = fused

        def select(self, node):
            return node._op == "Activation"

        def select_input(self, node, inp):
            return inp._op == "FullyConnected"

        def create_fn(self, sub_sym, arg_names):
            if self._fused is None:
                return None
            calls, fused = self.calls, self._fused

            def fn(*args):
                calls.append(arg_names)
                return fused(*args)

            return fn

    return FuseDenseRelu


JaxFuse = _fuse_dense_relu(jsubgraph.SubgraphProperty)
PortFuse = _fuse_dense_relu(subgraph.SubgraphProperty)


def _jax_dense_relu(x, w, b):
    import jax.numpy as jnp

    return jnp.maximum(x @ w.T + b, 0.0)


def _port_dense_relu(x, w, b):
    return torch.relu(x @ w.T + b)


def _port_rtc_dense_relu(x, w, b):
    # The matmul stays torch.matmul, as the JAX fixture computes it
    # outside its Pallas kernel; the relu is the rtc kernel's wrapper.
    return rtc_kernels.relu(torch.matmul(x, w.T) + b)


def _params(sym, x):
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=x.shape)
    return {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}


def _run(pkg, sym, x, params):
    args = dict(params, data=x)
    with pkg.cpu():
        ex = sym.bind(args={k: pkg.nd.array(v) for k, v in args.items()},
                      grad_req="null")
        return ex.forward(is_train=False)[0].asnumpy()


def _fragments(sym):
    return [(n._num_outputs, list(n._sub_arg_names),
             n._attrs["__subgraph_backend__"])
            for n in sym._topo() if n._op == "_subgraph"]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_partition_custom_fn_runs_and_matches():
    x = np.random.RandomState(1).rand(4, 6).astype(np.float32)
    jsym, psym = _dense_relu_sym(jmx), _dense_relu_sym(mx)
    params = _params(jsym, x)
    jprop = jsubgraph.register_backend("dense_relu_fused_torch_test",
                                       JaxFuse(_jax_dense_relu))
    pprop = subgraph.register_backend("dense_relu_fused_torch_test",
                                      PortFuse(_port_dense_relu))
    jpart = jsubgraph.partition(jsym, "dense_relu_fused_torch_test")
    ppart = subgraph.partition(psym, "dense_relu_fused_torch_test")
    assert _fragments(ppart) == _fragments(jpart)
    assert subgraph.list_backends().count("dense_relu_fused_torch_test") == 1
    want = _run(jmx, jpart, x, params)
    _close(_run(mx, ppart, x, params), want)
    _close(want, _run(jmx, jsym, x, params))
    assert pprop.calls and len(pprop.calls[0]) == 3
    assert pprop.calls[0] == jprop.calls[0]


def test_partition_fallback_evaluates_subdag():
    x = np.random.RandomState(2).rand(5, 6).astype(np.float32)
    jsym, psym = _dense_relu_sym(jmx), _dense_relu_sym(mx)
    params = _params(jsym, x)
    jpart = jsubgraph.partition(jsym, JaxFuse())
    ppart = subgraph.partition(psym, PortFuse())
    assert _fragments(ppart) == _fragments(jpart) != []
    _close(_run(mx, ppart, x, params), _run(jmx, jpart, x, params))
    _close(_run(mx, ppart, x, params), _run(mx, psym, x, params))


def test_partition_exposes_external_consumers_as_outputs():
    def build(F):
        data = F.sym.var("data")
        fc = F.sym.FullyConnected(data, num_hidden=4, name="fc")
        act = F.sym.Activation(fc, act_type="relu", name="act")
        return act + fc

    with jmx.name.NameManager():
        jboth = build(jmx)
    with mx.name.NameManager():
        pboth = build(mx)
    jpart = jsubgraph.partition(jboth, JaxFuse())
    ppart = subgraph.partition(pboth, PortFuse())
    assert _fragments(ppart) == _fragments(jpart)
    assert [f[0] for f in _fragments(ppart)] == [2]
    x = np.random.RandomState(3).rand(2, 6).astype(np.float32)
    params = _params(jboth, x)
    _close(_run(mx, ppart, x, params), _run(jmx, jpart, x, params))


def test_partition_rtc_backend():
    """The rtc story: a kernel compiled at runtime as the fused region's
    executor (its plain version on the host), against the JAX package's
    Pallas kernel in interpret mode."""

    class PallasDenseRelu(JaxFuse):
        def create_fn(self, sub_sym, arg_names):
            import jax.numpy as jnp

            from mxnet_tpu import rtc as jrtc
            from mxnet_tpu.ndarray.ndarray import NDArray

            def relu_kernel(x_ref, o_ref):
                o_ref[:] = jnp.maximum(x_ref[:], 0.0)

            k = jrtc.PallasModule(fused_relu=relu_kernel).get_kernel(
                "fused_relu")
            return lambda x, w, b: k.launch([NDArray(x @ w.T + b)])._data

    x = np.random.RandomState(4).rand(4, 6).astype(np.float32)
    jsym, psym = _dense_relu_sym(jmx), _dense_relu_sym(mx)
    params = _params(jsym, x)
    jpart = jsubgraph.partition(jsym, PallasDenseRelu())
    ppart = subgraph.partition(psym, PortFuse(_port_rtc_dense_relu))
    assert _fragments(ppart)[0][:2] == _fragments(jpart)[0][:2]
    launches = dict(rtc_kernels.LAUNCHES)
    _close(_run(mx, ppart, x, params), _run(jmx, jpart, x, params),
           tol=1e-4)
    assert rtc_kernels.LAUNCHES == launches  # host: the plain version


def test_partition_without_a_match_returns_the_symbol():
    psym = _dense_relu_sym(mx)

    class Never(subgraph.SubgraphProperty):
        pass

    assert subgraph.partition(psym, Never()) is psym
    with pytest.raises(ValueError, match="unknown subgraph backend"):
        subgraph.partition(psym, "no_such_backend")


def test_fused_bn_relu_on_resnet18_matches_jax_unpartitioned(tmp_path):
    rng = np.random.RandomState(5)
    jnet = jvision.resnet18_v1(classes=8, thumbnail=True)
    jnet.initialize()
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    with jmx.autograd.pause():
        jnet(jmx.nd.array(x))
    for name, p in jnet.collect_params().items():
        if name.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "gamma")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
    prefix = str(tmp_path / "r18")
    jnet.export(prefix)
    jsym, jargs, jaux = jmx.model.load_checkpoint(prefix, 0)
    feed = dict(jargs, data=jmx.nd.array(x))
    want = jsym.bind(jmx.cpu(), feed, aux_states=jaux,
                     grad_req="null").forward(is_train=False)[0].asnumpy()

    sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=mx.cpu())
    part = subgraph.partition(sym, fused_bn_relu.BACKEND)
    frags = [n for n in part._topo() if n._op == "_subgraph"]
    assert len(frags) == 8
    assert all(n._num_outputs == 1 and len(n._sub_arg_names) == 5
               and n._sub_fn is not None for n in frags)
    launches = fused_bn_relu.LAUNCHES
    with mx.cpu():
        ex = part.bind(mx.cpu(), dict(args, data=mx.nd.array(x)),
                       aux_states=aux, grad_req="null")
        got = ex.forward(is_train=False)[0].asnumpy()
    assert fused_bn_relu.LAUNCHES == launches
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fused_bn_relu_with_a_shared_batchnorm_output():
    """BatchNorm -> relu where the BatchNorm output is also added to the
    relu: the fragment has two outputs, the fused function (not the
    embedded sub-DAG) runs it and returns both, in the fragment's order,
    the same fragment as the JAX package's partition builds."""

    def build(F):
        data = F.sym.var("data")
        bn = F.sym.BatchNorm(data, fix_gamma=False, eps=1e-5, name="bn")
        act = F.sym.Activation(bn, act_type="relu", name="act")
        return act + bn

    class JaxBNReLU(jsubgraph.SubgraphProperty):
        inference_only = True

        def select(self, node):
            return node._op == "Activation"

        def select_input(self, node, inp):
            return inp._op == "BatchNorm"

    with jmx.name.NameManager():
        jsym = build(jmx)
    with mx.name.NameManager():
        psym = build(mx)
    part = subgraph.partition(psym, fused_bn_relu.BACKEND)
    frags = [n for n in part._topo() if n._op == "_subgraph"]
    assert len(frags) == 1 and frags[0]._sub_fn is not None
    assert [f[:2] for f in _fragments(part)] == \
        [f[:2] for f in _fragments(jsubgraph.partition(jsym, JaxBNReLU()))]
    assert _fragments(part)[0][0] == 2

    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    args = {"data": x, "bn_gamma": rng.uniform(0.5, 1.5, 3),
            "bn_beta": rng.uniform(-0.5, 0.5, 3)}
    aux = {"bn_moving_mean": rng.uniform(-0.5, 0.5, 3),
           "bn_moving_var": rng.uniform(0.5, 1.5, 3)}
    args, aux = ({k: v.astype(np.float32) for k, v in d.items()}
                 for d in (args, aux))

    def run(pkg, sym):
        with pkg.cpu():
            ex = sym.bind(pkg.cpu(),
                          {k: pkg.nd.array(v) for k, v in args.items()},
                          aux_states={k: pkg.nd.array(v)
                                      for k, v in aux.items()},
                          grad_req="null")
            return ex.forward(is_train=False)[0].asnumpy()

    want = run(jmx, jsym)
    launches = fused_bn_relu.LAUNCHES
    _close(run(mx, part), want)
    _close(run(mx, psym), want)
    assert fused_bn_relu.LAUNCHES == launches  # host: the plain version
