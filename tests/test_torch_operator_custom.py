"""``mx.operator`` (custom operators) of the port against the JAX
package's, on the same numpy inputs.

- the sigmoid op of tests/test_contrib.py, imperative (under
  ``autograd.record()``) and bound in an Executor: forward and gradient
  equal to the JAX package's within 1e-6 relative (float32 arithmetic in
  both, written the same way);
- a two-input, two-output op, forward and both gradients;
- ``CustomOp.assign`` under ``"write"``, ``"add"`` and ``"null"``;
- ``Custom`` inside a hybridized ``HybridBlock``, output and the Dense
  gradients against the JAX package's;
- ``Symbol.infer_shape`` takes a Custom node's shapes from
  ``CustomOpProp.infer_shape`` (the label's too) and never calls the
  user's ``forward`` (a counter);
- an unregistered ``op_type`` raises the JAX package's ``ValueError``;
- a small ``Module`` with upstream's custom softmax head
  (example/numpy-ops/custom_softmax.py, in NDArray arithmetic): one SGD
  step equal to the JAX package's within 1e-5 relative, and to the same
  Module with ``SoftmaxOutput``;
- on a card (``cuda``): the callbacks get arrays on ``gpu(0)`` and the
  real context.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

torch.set_num_threads(2)

C = mx.cpu()
RTOL = 1e-6
CALLS = {"forward": 0, "backward": 0}


def _register(m, tag=""):
    """The test ops, registered in package `m` (each package has its own
    registry): sigmoid, addsub (two in, two out), softmax (upstream's
    custom softmax head) and tile2 (output shape not the input's)."""
    _ = m.operator

    class Sigmoid(m.operator.CustomOp):
        def __init__(self, seen):
            self.seen = seen

        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS["forward"] += 1
            self.seen.append([x.context for x in in_data])
            y = 1.0 / (1.0 + (-in_data[0]).exp())
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            CALLS["backward"] += 1
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @m.operator.register("sigmoid" + tag)
    class SigmoidProp(m.operator.CustomOpProp):
        seen = []
        contexts = []

        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            SigmoidProp.contexts.append(ctx)
            return Sigmoid(SigmoidProp.seen)

    class AddSub(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a + b)
            self.assign(out_data[1], req[1], a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            g0, g1 = out_grad
            self.assign(in_grad[0], req[0], g0 + g1 * b)
            self.assign(in_grad[1], req[1], g0 + g1 * a)

    @m.operator.register("addmul" + tag)
    class AddSubProp(m.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "product"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return AddSub()

    class Softmax(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = m.nd.broadcast_sub(x, x.max(axis=1, keepdims=True)).exp()
            self.assign(out_data[0], req[0],
                        m.nd.broadcast_div(e, e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            onehot = m.nd.one_hot(in_data[1], y.shape[1])
            self.assign(in_grad[0], req[0], y - onehot)

    @m.operator.register("softmax" + tag)
    class SoftmaxProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Tile2(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS["forward"] += 1
            self.assign(out_data[0], req[0],
                        m.nd.concat(in_data[0], in_data[0], dim=1))

    @m.operator.register("tile2" + tag)
    class Tile2Prop(m.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            n, c = in_shape[0]
            return in_shape, [(n, 2 * c)], []

        def create_operator(self, ctx, shapes, dtypes):
            return Tile2()

    return SigmoidProp


_register(jmx)
SIGMOID = _register(mx)


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _imperative(m, x_np, ctx):
    x = m.nd.array(x_np, ctx=ctx)
    x.attach_grad()
    with m.autograd.record():
        y = m.nd.Custom(x, op_type="sigmoid")
        loss = (y * y).sum()
    loss.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_sigmoid_imperative_matches_jax():
    x = _x()
    got_y, got_g = _imperative(mx, x, C)
    want_y, want_g = _imperative(jmx, x, jmx.cpu())
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL)
    s = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(got_g, 2 * s * s * (1 - s), rtol=1e-5)


def _bound(m, x_np, ctx):
    data = m.sym.var("data")
    out = m.sym.Custom(data, op_type="sigmoid", name="cust")
    ex = out.bind(ctx, {"data": m.nd.array(x_np, ctx=ctx)},
                  args_grad={"data": m.nd.zeros(x_np.shape, ctx=ctx)})
    y = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[m.nd.array(np.full(x_np.shape, 0.5, np.float32),
                                      ctx=ctx)])
    return y, ex.grad_dict["data"].asnumpy()


def test_sigmoid_in_an_executor_matches_jax():
    x = _x((2, 5), 1)
    got_y, got_g = _bound(mx, x, C)
    want_y, want_g = _bound(jmx, x, jmx.cpu())
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL)


def _addmul(m, a_np, b_np, ctx):
    a, b = m.nd.array(a_np, ctx=ctx), m.nd.array(b_np, ctx=ctx)
    a.attach_grad()
    b.attach_grad()
    with m.autograd.record():
        s, p = m.nd.Custom(a, b, op_type="addmul")
        loss = (s * 2 + p * p).sum()
    loss.backward()
    return [v.asnumpy() for v in (s, p, a.grad, b.grad)]


def test_two_inputs_two_outputs_match_jax():
    a, b = _x((4, 3), 2), _x((4, 3), 3)
    got = _addmul(mx, a, b, C)
    want = _addmul(jmx, a, b, jmx.cpu())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got[2], 2 + 2 * a * b * b, rtol=1e-5)
    data = [mx.sym.var("a"), mx.sym.var("b")]
    sym = mx.sym.Custom(*data, op_type="addmul")
    assert sym.list_outputs() == jmx.sym.Custom(
        jmx.sym.var("a"), jmx.sym.var("b"),
        op_type="addmul").list_outputs()
    assert len(sym.list_outputs()) == 2


@pytest.mark.parametrize("req", ["write", "add", "null", "inplace"])
def test_assign_honours_req_as_the_jax_package(req):
    got = mx.nd.ones((2, 3), ctx=C)
    want = jmx.nd.ones((2, 3))
    mx.operator.CustomOp.assign(got, req, mx.nd.full((2, 3), 2.5, ctx=C))
    jmx.operator.CustomOp.assign(want, req, jmx.nd.full((2, 3), 2.5))
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(want.asnumpy()))
    assert float(got.asnumpy()[0, 0]) == {"write": 2.5, "inplace": 2.5,
                                          "add": 3.5, "null": 1.0}[req]


def test_assign_refuses_an_unknown_req():
    with pytest.raises(ValueError, match="unknown req"):
        mx.operator.CustomOp.assign(mx.nd.ones((1,), ctx=C), "sum",
                                    mx.nd.ones((1,), ctx=C))


def _hybrid(m, weights, x_np, ctx, prefix):
    class Net(m.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = m.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.fc(x), op_type="sigmoid")

    net = Net(prefix=prefix)
    net.initialize(ctx=ctx)
    if weights is not None:
        if m is mx:
            mx.gluon.utils.params_from_numpy(net, weights[0],
                                             prefix=weights[1])
        else:
            for name, p in net.collect_params().items():
                p.set_data(m.nd.array(weights[0][name]))
    net.hybridize()
    x = m.nd.array(x_np, ctx=ctx)
    with m.autograd.record():
        y = net(x)
        loss = y.sum()
    loss.backward()
    # Keyed by relative name: block counters depend on what the process
    # built before (gluon.utils.relative_names renumbers them).
    params = net.collect_params()
    rel = mx.gluon.utils.relative_names(list(params.keys()), net.prefix)
    grads = {rel[n]: p.grad().asnumpy() for n, p in params.items()}
    return net, y.asnumpy(), grads


def test_custom_in_a_hybridized_block_matches_jax():
    x = _x((5, 3), 4)
    jnet, want_y, want_g = _hybrid(jmx, None, x, jmx.cpu(), "jnet_")
    weights = ({n: p.data().asnumpy()
                for n, p in jnet.collect_params().items()}, jnet.prefix)
    net, got_y, got_g = _hybrid(mx, weights, x, C, "tnet_")
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # a second call of the same signature (train mode) reuses its entry
    with mx.autograd.record():
        net(mx.nd.array(x, ctx=C))
    assert net._cached_op.num_traces == 1


def test_infer_shape_uses_the_prop_and_never_runs_forward():
    CALLS["forward"] = 0
    data = mx.sym.var("data")
    tiled = mx.sym.Custom(data, op_type="tile2", name="t")
    fc = mx.sym.FullyConnected(tiled, num_hidden=3, name="fc")
    head = mx.sym.Custom(fc, mx.sym.var("softmax_label"), op_type="softmax",
                         name="sm")
    arg_shapes, out_shapes, _ = head.infer_shape(data=(6, 5))
    assert CALLS["forward"] == 0
    args = dict(zip(head.list_arguments(), arg_shapes))
    assert args == {"data": (6, 5), "fc_weight": (3, 10), "fc_bias": (3,),
                    "softmax_label": (6,)}
    assert out_shapes == [(6, 3)]
    j = jmx.sym.Custom(jmx.sym.var("data"), op_type="tile2", name="t")
    assert tiled.infer_shape(data=(6, 5))[1] == \
        [tuple(s) for s in j.infer_shape(data=(6, 5))[1]] == [(6, 10)]
    assert CALLS["forward"] == 0


def test_an_unregistered_op_raises_the_jax_packages_error():
    x = mx.nd.ones((2, 2), ctx=C)
    with pytest.raises(ValueError, match="custom op 'nope' is not registered"):
        mx.nd.Custom(x, op_type="nope")
    with pytest.raises(ValueError, match="custom op 'nope' is not registered"):
        jmx.nd.Custom(jmx.nd.ones((2, 2)), op_type="nope")
    with pytest.raises(ValueError, match="custom op 'nope' is not registered"):
        mx.sym.Custom(mx.sym.var("data"), op_type="nope")
    assert "sigmoid" in mx.operator.get_all_registered_operators()


def _mlp(m, head):
    data = m.sym.var("data")
    label = m.sym.var("softmax_label")
    h = m.sym.Activation(m.sym.FullyConnected(data, num_hidden=16,
                                              name="fc1"), act_type="relu")
    out = m.sym.FullyConnected(h, num_hidden=5, name="fc2")
    if head == "custom":
        return m.sym.Custom(out, label, op_type="softmax", name="softmax")
    return m.sym.SoftmaxOutput(out, label, name="softmax")


def _module_step(m, head, ctx, w0, x, y):
    mod = m.mod.Module(_mlp(m, head), context=ctx,
                       label_names=["softmax_label"])
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params={k: m.nd.array(v, ctx=ctx)
                                for k, v in w0.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    batch = m.io.DataBatch([m.nd.array(x, ctx=ctx)],
                           [m.nd.array(y, ctx=ctx)])
    mod.forward_backward(batch)
    mod.update()
    prob = mod.get_outputs()[0].asnumpy()
    return prob, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_with_a_custom_softmax_head_matches_jax_and_softmax_output():
    rng = np.random.default_rng(6)
    w0 = {"fc1_weight": rng.standard_normal((16, 10), np.float32) * 0.3,
          "fc1_bias": np.zeros(16, np.float32),
          "fc2_weight": rng.standard_normal((5, 16), np.float32) * 0.3,
          "fc2_bias": np.zeros(5, np.float32)}
    x = rng.standard_normal((8, 10), np.float32)
    y = rng.integers(0, 5, 8).astype(np.float32)
    with mx.cpu():
        got_p, got = _module_step(mx, "custom", C, w0, x, y)
        ref_p, ref = _module_step(mx, "softmax_output", C, w0, x, y)
    want_p, want = _module_step(jmx, "custom", jmx.cpu(), w0, x, y)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-5, atol=1e-7)
    for k in w0:
        for other in (want, ref):
            np.testing.assert_allclose(got[k] - w0[k], other[k] - w0[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert np.abs(got[k] - w0[k]).max() > 0, k


@pytest.mark.cuda
def test_callbacks_get_card_arrays_and_the_real_context():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    SIGMOID.seen.clear()
    SIGMOID.contexts.clear()
    x = _x()
    got_y, got_g = _imperative(mx, x, mx.gpu(0))
    want_y, want_g = _imperative(mx, x, C)
    assert SIGMOID.contexts[0] == mx.gpu(0)
    assert all(c == mx.gpu(0) for c in SIGMOID.seen[0])
    np.testing.assert_allclose(got_y, want_y, rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6)
