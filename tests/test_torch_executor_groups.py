"""group2ctx: the executor's placement of op groups across devices.

The port against the JAX package's executor on the host, where the
groups go to ``cpu(1)``/``cpu(2)`` (devices of the JAX package's virtual
CPU mesh; one torch device and two contexts in the port), with
tests/test_executor_groups.py's two-group symbol and tolerances
(forward rtol 1e-5, gradients rtol 1e-4, atol 1e-5); with
``MXNET_SUBGRAPH_BACKEND`` set; and ``examples/model_parallel_lstm.py``
against the port's example. On a card (marker ``cuda``): the groups on
``gpu(0)`` and ``cpu(0)`` against one device.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor as mx_executor
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import model_parallel_lstm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_group_symbol(pkg):
    x = pkg.sym.Variable("x")
    with pkg.AttrScope(ctx_group="dev1"):
        h = pkg.sym.FullyConnected(x, num_hidden=6, name="fc1")
        h = pkg.sym.Activation(h, act_type="relu", name="act1")
    with pkg.AttrScope(ctx_group="dev2"):
        out = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return out


def _arrays(seed=7):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(4, 5).astype(np.float32),
            "fc1_weight": rng.randn(6, 5).astype(np.float32),
            "fc1_bias": rng.randn(6).astype(np.float32),
            "fc2_weight": rng.randn(3, 6).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}


def _bind(pkg, ctx, group2ctx, arrays):
    nd = pkg.nd
    kw = {} if pkg is jmx else {"ctx": ctx}
    args = {k: nd.array(v, **kw) for k, v in arrays.items()}
    grads = {k: nd.zeros(v.shape, **kw) for k, v in arrays.items()}
    return _two_group_symbol(pkg).bind(ctx, args, args_grad=grads,
                                       group2ctx=group2ctx)


def _run(ex, head=None):
    out = ex.forward(is_train=True)[0]
    got = out.asnumpy()
    ex.backward(head)
    return out, got, {k: g.asnumpy() for k, g in ex.grad_dict.items()}


def _jax_devices(out):
    return {d.id for d in out._data.devices()}


def _hold(port, jax_):
    np.testing.assert_allclose(port[1], jax_[1], rtol=1e-5, atol=1e-5)
    for k, g in jax_[2].items():
        np.testing.assert_allclose(port[2][k], g, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_group2ctx_places_and_computes_as_the_jax_package():
    arrays = _arrays()
    before = list(mx_executor.CROSS_DEVICE_BYTES)
    port = _run(_bind(mx, mx.cpu(), {"dev1": mx.cpu(1), "dev2": mx.cpu(2)},
                      arrays))
    plain = _run(_bind(mx, mx.cpu(), None, arrays))
    jax_ = _run(_bind(jmx, jmx.cpu(), {"dev1": jmx.Context("cpu", 1),
                                       "dev2": jmx.Context("cpu", 2)},
                      arrays))
    _hold(port, jax_)
    # One torch device: the placed graph is the plain graph's bits, and
    # nothing crossed a device boundary.
    np.testing.assert_array_equal(port[1], plain[1])
    for k in arrays:
        np.testing.assert_array_equal(port[2][k], plain[2][k], err_msg=k)
    assert mx_executor.CROSS_DEVICE_BYTES == before
    # The output is the dev2 group's, as the JAX output lives on device 2.
    assert _jax_devices(jax_[0]) == {2}
    assert port[0].context == mx.cpu(2)
    assert plain[0].context == mx.cpu()


def test_group2ctx_raises_for_an_unknown_group_or_an_absent_device():
    arrays = _arrays()
    with pytest.raises(MXNetError, match="no entry in group2ctx"):
        _bind(mx, mx.cpu(), {"dev1": mx.cpu(1)}, arrays)
    with pytest.raises(jmx.MXNetError):
        _bind(jmx, jmx.cpu(), {"dev1": jmx.cpu(1)}, arrays)
    absent = mx.gpu(torch.cuda.device_count())
    with pytest.raises(RuntimeError, match="CUDA device"):
        _bind(mx, mx.cpu(), {"dev1": mx.cpu(1), "dev2": absent}, arrays)


def _backend(pkg, first, then, fn, name):
    class Select(pkg.subgraph.SubgraphProperty):
        def select(self, node):
            return node._name == first

        def select_output(self, node, consumer):
            return consumer._name == then

        def create_fn(self, sub_sym, arg_names):
            return fn

    pkg.subgraph.register_backend(name, Select())


def test_group2ctx_with_a_subgraph_backend(monkeypatch):
    """A fragment carries no group and runs where its inputs are, in
    both packages: here fc1 and its relu, fed by x and fc1's weights on
    the executor's device, and the dev2 group still makes the output.
    (A fragment fed from two devices raises in the JAX package, and in
    the port wherever the two are different torch devices.)"""
    import jax.numpy as jnp

    _backend(mx, "fc1", "act1",
             lambda x, w, b: torch.relu(x @ w.t() + b), "test_groups_mid")
    _backend(jmx, "fc1", "act1",
             lambda x, w, b: jnp.maximum(x @ w.T + b, 0), "test_groups_mid")
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "test_groups_mid")
    arrays = _arrays(3)
    port_ex = _bind(mx, mx.cpu(), {"dev1": mx.cpu(1), "dev2": mx.cpu(2)},
                    arrays)
    jax_ex = _bind(jmx, jmx.cpu(), {"dev1": jmx.Context("cpu", 1),
                                    "dev2": jmx.Context("cpu", 2)}, arrays)
    assert any(n._op == "_subgraph" for n in port_ex._symbol._topo())
    assert any(n._op == "_subgraph" for n in jax_ex._symbol._topo())
    port, jax_ = _run(port_ex), _run(jax_ex)
    _hold(port, jax_)
    assert _jax_devices(jax_[0]) == {2}
    assert port[0].context == mx.cpu(2)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_model_parallel_lstm",
        os.path.join(ROOT, "examples", "model_parallel_lstm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_parallel_lstm_learns_from_the_jax_examples_start():
    """12 steps at batch 64 and rate 10 (at the default batch of 8 and
    rate 0.3, 12 steps do not learn in either package); the first loss
    is the JAX example's on the same weights and first batch."""
    flags = ["--steps", "12", "--batch-size", "64", "--lr", "10.0"]
    seed, batch, seq_len, vocab = 11, 64, 4, 20
    sym = _jax_example().build_lm(seq_len, vocab, 16, 16, 2)
    shapes, _, _ = sym.infer_shape(data=(batch, seq_len),
                                   softmax_label=(batch, seq_len))
    rng = np.random.RandomState(5)
    weights = {n: (rng.randn(*s) * 0.3).astype(np.float32)
               for n, s in zip(sym.list_arguments(), shapes)
               if n not in ("data", "softmax_label")}
    seqs = model_parallel_lstm.sample_seqs(np.random.RandomState(seed),
                                           batch, seq_len, vocab)
    args = {n: jmx.nd.array(v) for n, v in weights.items()}
    args["data"] = jmx.nd.array(seqs[:, :-1].astype(np.float32))
    args["softmax_label"] = jmx.nd.array(seqs[:, 1:].astype(np.float32))
    groups = ["embed", "layer0", "layer1", "head"]
    ex = sym.bind(jmx.cpu(), args, grad_req="null", group2ctx={
        g: jmx.Context("cpu", i) for i, g in enumerate(groups)})
    p = ex.forward(is_train=True)[0].asnumpy().reshape(batch, seq_len,
                                                       vocab)
    want = -np.log(np.maximum(np.take_along_axis(
        p, seqs[:, 1:, None].astype(int), axis=2), 1e-9)).mean()
    got = model_parallel_lstm.main(flags + ["--device", "cpu",
                                            "--seed", str(seed)],
                                   arg_params=weights)
    np.testing.assert_allclose(got["history"][0], want, rtol=1e-5)
    assert got["last"] < got["first"]
    assert got["placement"] == {g: "cpu(%d)" % i
                                for i, g in enumerate(groups)}
    assert got["cross_bytes_per_step"] == [0] * 12


@pytest.mark.cuda
def test_group2ctx_across_the_card_and_the_host():
    """The groups on gpu(0) and cpu(0), both ways round, against one
    device: the same values and gradients, each output on its group's
    device and each gradient on its argument's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays = _arrays()
    plain = _run(_bind(mx, mx.cpu(), None, arrays))
    for g1, g2 in ((mx.gpu(0), mx.cpu(0)), (mx.cpu(0), mx.gpu(0))):
        before = sum(mx_executor.CROSS_DEVICE_BYTES)
        ex = _bind(mx, mx.cpu(), {"dev1": g1, "dev2": g2}, arrays)
        got = _run(ex)
        np.testing.assert_allclose(got[1], plain[1], rtol=1e-5, atol=1e-5)
        for k in arrays:
            np.testing.assert_allclose(got[2][k], plain[2][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert got[0].context == g2
        assert got[0]._data.device == g2.torch_device
        for k, g in ex.grad_dict.items():
            assert g._data.device.type == "cpu", k
        assert sum(mx_executor.CROSS_DEVICE_BYTES) > before
