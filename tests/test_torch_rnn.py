"""The recurrent path of mxnet_tpu_torch against the JAX package.

The same numpy inputs, from a seed, go through both packages:

- the shape and elementwise ops the cells compose, Dropout, Embedding
  (out-of-range indices included) and the Sequence* ops (with and
  without lengths, on both axes where the op has them): forward and
  the gradient of a random projection of the outputs;
- the fused RNN op over modes x layers 1-2 x bidirectional x
  state_outputs, and the LSTM cell clip, with gradients with respect to
  data, parameters and states; the layout helpers;
- the gluon cells (``unroll`` with ``valid_length``, hybridized) and
  layers (weights carried by ``gluon.utils.params_from_numpy``), and
  ``unfuse``;
- the legacy symbolic cells bound through the Executor, FusedRNNCell's
  pack/unpack, the FusedRNN and LSTMBias initializers;
- ``BucketSentenceIter`` batches, ``save``/``load_rnn_checkpoint`` files
  read by the other package, and a small LSTM language model through
  ``BucketingModule``, step by step over three buckets from one state.

fp32 throughout. Forward values within rtol 1e-5 / atol 1e-6 of the JAX
package's; gradients and trained weights within rtol 1e-5 and an atol of
1e-5 of the tensor's largest entry (sums in another order; the port's
RNN op adds both biases before the step loop). Dropout is compared in
eval mode or at p = 0 (the two packages' RNGs differ); its training
mask is checked by its keep fraction and scale.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import rnn_ops as jrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import params_from_numpy
from mxnet_tpu_torch.ops import rnn_ops

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_scaled(got, want):
    """Within rtol 1e-5 and 1e-5 of the largest entry of `want`."""
    want = np.asarray(want)
    _close(got, want, atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _forward_backward(pkg, name, arrays, attrs, grad_idx, heads, named=(),
                      train=True):
    """Outputs of nd.<name>(*arrays, **attrs) and the gradients of
    sum(out_k * heads[k]) with respect to arrays[grad_idx]."""
    nds = [pkg.nd.array(a) for a in arrays]
    for i in grad_idx:
        nds[i].attach_grad()
    kw = dict(attrs)
    for k in named:   # (keyword, index) inputs passed by keyword
        kw[k[0]] = nds[k[1]]
    pos = [a for i, a in enumerate(nds) if i not in {k[1] for k in named}]
    with pkg.autograd.record(train_mode=train):
        outs = _as_list(getattr(pkg.nd, name)(*pos, **kw))
        loss = None
        for o, h in zip(outs, heads):
            term = (o * pkg.nd.array(h)).sum()
            loss = term if loss is None else loss + term
    if grad_idx:
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [nds[i].grad.asnumpy() for i in grad_idx])


def _parity(name, arrays, attrs, grad_idx=(0,), named=(), seed=0,
            train=True):
    with mx.autograd.pause():
        shapes = [o.shape for o in _as_list(getattr(mx.nd, name)(
            *[mx.nd.array(a) for i, a in enumerate(arrays)
              if i not in {k[1] for k in named}],
            **dict(attrs, **{k: mx.nd.array(arrays[i]) for k, i in named})))]
    rng = np.random.RandomState(seed + 100)
    heads = [rng.randn(*s).astype(np.float32) for s in shapes]
    j_out, j_grad = _forward_backward(jmx, name, arrays, attrs, grad_idx,
                                      heads, named, train)
    p_out, p_grad = _forward_backward(mx, name, arrays, attrs, grad_idx,
                                      heads, named, train)
    assert len(p_out) == len(j_out)
    for p, j in zip(p_out, j_out):
        assert p.shape == j.shape
        _close(p, j)
    for p, j in zip(p_grad, j_grad):
        _close_scaled(p, j)
    return p_out, p_grad


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the ops the cells compose -------------------------------------------------

OP_CASES = {
    "split": ([_randn(2, 6, 3)], {"num_outputs": 3, "axis": 1}),
    "split_squeeze": ([_randn(2, 3, 4)], {"num_outputs": 3, "axis": 1,
                                          "squeeze_axis": True}),
    "SliceChannel": ([_randn(4, 6)], {"num_outputs": 2, "axis": -1}),
    "slice_axis": ([_randn(3, 7)], {"axis": 1, "begin": 2, "end": 5}),
    "slice_axis_open": ([_randn(5, 2)], {"axis": 0, "begin": -3,
                                         "end": None}),
    "expand_dims": ([_randn(3, 4)], {"axis": 1}),
    "broadcast_axis": ([_randn(3, 1, 2)], {"axis": 1, "size": 4}),
    "broadcast_axes": ([_randn(1, 1, 2)], {"axis": (0, 1), "size": (2, 3)}),
    "zeros_like": ([_randn(2, 3)], {}),
    "ones_like": ([_randn(2, 3)], {}),
    "sigmoid": ([_randn(3, 4)], {}),
    "tanh": ([_randn(3, 4)], {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_shape_and_unary_ops(case):
    arrays, attrs = OP_CASES[case]
    name = case.split("_squeeze")[0].split("_open")[0]
    if case == "broadcast_axes":
        name = "broadcast_axis"
    _parity(name, arrays, attrs)


@pytest.mark.parametrize("name", ["concat", "stack"])
def test_variadic_ops(name):
    arrays = [_randn(2, 3, seed=s) for s in range(3)]
    attrs = {"dim": 1} if name == "concat" else {"axis": 1}
    _parity(name, arrays, attrs, grad_idx=(0, 1, 2))


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_take_out_of_range(mode):
    idx = np.array([[0, 4, -2], [7, 1, 2.6]], np.float32)
    out, _ = _parity("take", [_randn(5, 3), idx], {"axis": 0, "mode": mode})
    assert out[0].shape == (2, 3, 3)


def test_where():
    cond = np.array([[1, 0, 2], [0, 0, -1]], np.float32)
    _parity("where", [cond, _randn(2, 3), _randn(2, 3, seed=1)], {},
            grad_idx=(1, 2))


def test_ordering_comparisons_match_jax():
    a, b = _randn(3, 4), _randn(3, 4, seed=1)
    for op in ("__lt__", "__le__", "__gt__", "__ge__"):
        for rhs in (b, 0.25):
            got = getattr(mx.nd.array(a), op)(
                mx.nd.array(rhs) if isinstance(rhs, np.ndarray) else rhs)
            want = getattr(jmx.nd.array(a), op)(
                jmx.nd.array(rhs) if isinstance(rhs, np.ndarray) else rhs)
            _close(got.asnumpy(), want.asnumpy())


# -- Dropout, Embedding --------------------------------------------------------

def test_dropout_eval_and_p0_are_identity():
    x = _randn(4, 5)
    _parity("Dropout", [x], {"p": 0.5}, train=False)   # the identity
    for pkg in PKGS:
        with pkg.autograd.record():
            y = pkg.nd.Dropout(pkg.nd.array(x), p=0.0)
        _close(y.asnumpy(), x)


@pytest.mark.parametrize("axes", [(), (1,)])
def test_dropout_training_mask(axes):
    """Train mode: about 1 - p of the elements kept, each scaled by
    1 / (1 - p); `axes` share one draw. Seeded draws repeat."""
    x = np.ones((2048, 32), np.float32)

    def draw():
        with mx.autograd.record():
            return mx.nd.Dropout(mx.nd.array(x), p=0.3, axes=axes).asnumpy()

    mx.random.seed(5)
    y = draw()
    kept = y != 0
    _close(y[kept], np.full(kept.sum(), 1 / 0.7, np.float32))
    assert abs(kept.mean() - 0.7) < 0.04   # 4 sigma at 2048 draws
    if axes:
        assert (kept == kept[:, :1]).all()
    mx.random.seed(5)
    np.testing.assert_array_equal(draw(), y)


def test_embedding_out_of_range_and_gradient():
    """Indices below 0 or past input_dim read the nearest row (the JAX
    op clips them); float indices are truncated. The gradient
    accumulates into the rows read."""
    idx = np.array([[0, 3, -4], [9, 2.7, 3]], np.float32)
    out, grads = _parity("Embedding", [idx, _randn(4, 3)],
                         {"input_dim": 4, "output_dim": 3}, grad_idx=(1,))
    w = _randn(4, 3)
    _close(out[0], w[np.clip(idx.astype(np.int64), 0, 3)])


def test_embedding_and_dropout_layers():
    x = np.array([[1, 5, 0], [2, 2, 7]], np.float32)
    outs = []
    for pkg in PKGS:
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Embedding(8, 4), pkg.gluon.nn.Dropout(0.5))
        net.initialize()
        if pkg is mx:
            params_from_numpy(net, {p.name: p.data().asnumpy() for p in
                                    jnet.collect_params().values()},
                              prefix=jnet.prefix)
        else:
            jnet = net
        outs.append(net(pkg.nd.array(x)).asnumpy())
    _close(outs[1], outs[0])


# -- Sequence* -------------------------------------------------------------------

LENGTHS = np.array([2, 5, 0.0, 3.9], np.float32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("name", ["SequenceMask", "SequenceLast"])
def test_sequence_ops(name, lengths, axis):
    data = _randn(5, 4, 3) if axis == 0 else _randn(4, 5, 3)
    attrs = {"axis": axis}
    if name == "SequenceMask":
        attrs["value"] = -1.5
    arrays, named = [data], ()
    if lengths:
        arrays.append(np.minimum(LENGTHS, 5))
        attrs["use_sequence_length"] = True
        named = (("sequence_length", 1),)
    _parity(name, arrays, attrs, named=named)


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_reverse(lengths):
    arrays, attrs, named = [_randn(5, 4, 3)], {}, ()
    if lengths:
        arrays.append(np.array([2, 5, 1, 3.5], np.float32))
        attrs["use_sequence_length"] = True
        named = (("sequence_length", 1),)
    _parity("SequenceReverse", arrays, attrs, named=named)
    with pytest.raises(ValueError, match="axis=0"):
        mx.nd.SequenceReverse(mx.nd.array(arrays[0]), axis=1)


# -- the fused RNN op ------------------------------------------------------------

T, N, I, H = 4, 3, 5, 6


def _rnn_inputs(mode, layers, bidir, seed=0):
    rng = np.random.RandomState(seed)
    d = 2 if bidir else 1
    size = rnn_ops.rnn_param_size(layers, H, I, mode, bidir)
    arrays = [rng.randn(T, N, I).astype(np.float32),
              (rng.randn(size) * 0.3).astype(np.float32),
              (rng.randn(layers * d, N, H) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rng.randn(layers * d, N, H) * 0.5).astype(np.float32))
    return arrays


@pytest.mark.parametrize("state_outputs", [False, True])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_rnn_op(mode, layers, bidir, state_outputs):
    """Outputs, and gradients with respect to data, parameters and the
    initial states."""
    arrays = _rnn_inputs(mode, layers, bidir)
    outs, _ = _parity("RNN", arrays,
                      {"state_size": H, "num_layers": layers, "mode": mode,
                       "bidirectional": bidir,
                       "state_outputs": state_outputs},
                      grad_idx=tuple(range(len(arrays))))
    d = 2 if bidir else 1
    assert outs[0].shape == (T, N, d * H)
    assert len(outs) == (1 if not state_outputs else
                         3 if mode == "lstm" else 2)


def test_rnn_op_lstm_cell_clip():
    arrays = _rnn_inputs("lstm", 2, False, seed=3)
    arrays[1] *= 6
    outs, _ = _parity("RNN", arrays,
                      {"state_size": H, "num_layers": 2, "mode": "lstm",
                       "state_outputs": True, "lstm_state_clip_min": -0.2,
                       "lstm_state_clip_max": 0.3},
                      grad_idx=(0, 1, 2, 3))
    assert outs[2].min() >= -0.2 and outs[2].max() <= 0.3


def test_rnn_op_dropout_between_layers():
    """p > 0 drops only in training, between layers (a one-layer RNN is
    unchanged by it); p = 0 in training equals the JAX op."""
    arrays = _rnn_inputs("lstm", 2, False)
    attrs = {"state_size": H, "num_layers": 2, "mode": "lstm"}
    for pkg in PKGS:
        with pkg.autograd.record():
            got = pkg.nd.RNN(*[pkg.nd.array(a) for a in arrays], p=0.0,
                             **attrs).asnumpy()
        if pkg is jmx:
            want = got
    _close(got, want)
    nds = [mx.nd.array(a) for a in arrays]
    eval_out = mx.nd.RNN(*nds, p=0.5, **attrs).asnumpy()
    _close(eval_out, want)
    with mx.autograd.record():
        train_out = mx.nd.RNN(*nds, p=0.5, **attrs).asnumpy()
    assert not np.allclose(train_out, eval_out)
    one = _rnn_inputs("gru", 1, False)
    with mx.autograd.record():
        a = mx.nd.RNN(*[mx.nd.array(x) for x in one], state_size=H,
                      num_layers=1, mode="gru", p=0.5).asnumpy()
    _close(a, mx.nd.RNN(*[mx.nd.array(x) for x in one], state_size=H,
                        num_layers=1, mode="gru").asnumpy())


def test_rnn_op_projection_size_raises():
    arrays = [mx.nd.array(a) for a in _rnn_inputs("lstm", 1, False)]
    with pytest.raises(NotImplementedError, match="projection_size"):
        mx.nd.RNN(*arrays, state_size=H, num_layers=1, mode="lstm",
                  projection_size=3)


@pytest.mark.parametrize("mode", ["rnn_tanh", "lstm", "gru"])
def test_rnn_layout_helpers(mode):
    for layers, bidir, in_size in ((1, False, 5), (3, True, 7), (2, False, 1)):
        size = rnn_ops.rnn_param_size(layers, 4, in_size, mode, bidir)
        assert size == jrnn.rnn_param_size(layers, 4, in_size, mode, bidir)
        assert rnn_ops.rnn_param_layout(layers, 4, in_size, mode, bidir) \
            == jrnn.rnn_param_layout(layers, 4, in_size, mode, bidir)
        assert rnn_ops.rnn_infer_input_size(size, layers, 4, mode, bidir) \
            == in_size
        name, shape, off = rnn_ops.rnn_param_layout(layers, 4, in_size,
                                                    mode, bidir)[-1]
        assert off + int(np.prod(shape)) == size
    with pytest.raises(ValueError):
        rnn_ops.rnn_infer_input_size(size + 1, layers, 4, mode, bidir)


def test_rnn_symbol_shapes_and_outputs():
    for pkg in PKGS:
        data = pkg.sym.var("data")
        rnn = pkg.sym.RNN(data, state_size=H, num_layers=2, mode="gru",
                          state_outputs=True, name="rnn",
                          state=pkg.sym.var("rnn_state"))
        assert len(rnn) == 2
        arg_shapes, out_shapes, _ = rnn.infer_shape(data=(T, N, I))
        assert dict(zip(rnn.list_arguments(), map(tuple, arg_shapes)))[
            "rnn_parameters"] == (rnn_ops.rnn_param_size(2, H, I, "gru"),)
        if pkg is mx:
            assert [tuple(s) for s in out_shapes][0] == (T, N, H)


# -- gluon layers and cells ----------------------------------------------------

def _copy_weights(jnet, net):
    params_from_numpy(net, {p.name: p.data().asnumpy()
                            for p in jnet.collect_params().values()},
                      prefix=jnet.prefix)


def _layer(pkg, mode, **kw):
    cls = {"lstm": pkg.gluon.rnn.LSTM, "gru": pkg.gluon.rnn.GRU,
           "rnn_tanh": pkg.gluon.rnn.RNN}[mode]
    return cls(H, **kw)


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_gluon_layer_matches_jax(mode, layout):
    """Two bidirectional layers, weights from the JAX layer; outputs,
    final states and weight gradients. The port's hybridized call gives
    the same values."""
    x = _randn(T, N, I) if layout == "TNC" else _randn(N, T, I)
    head = _randn(*((T, N, 2 * H) if layout == "TNC" else (N, T, 2 * H)),
                  seed=1)
    res = {}
    for pkg in PKGS:
        layer = _layer(pkg, mode, num_layers=2, bidirectional=True,
                       layout=layout)
        layer.initialize(pkg.init.Xavier())
        if pkg is mx:
            layer(mx.nd.array(x))
            _copy_weights(jlayer, layer)
        else:
            jlayer = layer
            layer(pkg.nd.array(x))
        batch = N
        states = layer.begin_state(batch)
        with pkg.autograd.record():
            out, new_states = layer(pkg.nd.array(x), states)
            loss = (out * pkg.nd.array(head)).sum()
        loss.backward()
        res[pkg] = (out.asnumpy(), [s.asnumpy() for s in new_states],
                    {n[len(layer.prefix):]: p.grad().asnumpy()
                     for n, p in layer.collect_params().items()})
        if pkg is mx:
            layer.hybridize()
            _close(layer(pkg.nd.array(x)).asnumpy(), res[pkg][0])
    (jo, js, jg), (po, ps, pg) = res[jmx], res[mx]
    _close(po, jo)
    for p, j in zip(ps, js):
        _close(p, j)
    assert sorted(pg) == sorted(jg)
    for n in jg:
        _close_scaled(pg[n], jg[n])


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_gluon_unfuse_matches_fused(mode):
    layer = _layer(mx, mode, num_layers=2, bidirectional=True)
    layer.initialize(mx.init.Xavier())
    x = mx.nd.array(_randn(T, N, I))
    fused = layer(x).asnumpy()
    unfused, _ = layer.unfuse().unroll(T, x, layout="TNC",
                                       merge_outputs=True)
    _close(unfused.asnumpy(), fused, atol=1e-5)


def _cell(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "lstm":
        return rnn.LSTMCell(H)
    if kind == "gru":
        return rnn.GRUCell(H)
    if kind == "rnn":
        return rnn.RNNCell(H, activation="relu")
    if kind == "sequential":
        seq = rnn.SequentialRNNCell()
        seq.add(rnn.LSTMCell(H))
        seq.add(rnn.DropoutCell(0.5))
        seq.add(rnn.ResidualCell(rnn.GRUCell(H)))
        return seq
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(H), zoneout_outputs=0.3,
                               zoneout_states=0.2)
    return rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(H))


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "sequential",
                                  "zoneout", "bidirectional"])
def test_gluon_cell_unroll_matches_jax(kind, valid):
    """unroll (NTC, merged) from the JAX cell's weights, in eval mode
    (DropoutCell and ZoneoutCell then pass values through); with
    valid_length, padded steps are zero and each state is the one at the
    sequence's last valid step. Weight gradients for the plain cells."""
    x = _randn(N, T, H if kind == "sequential" else I)
    vl = np.array([2, 4, 1], np.float32)
    res = {}
    for pkg in PKGS:
        cell = _cell(pkg, kind)
        cell.initialize(pkg.init.Xavier())
        xs = pkg.nd.array(x)
        kw = {"valid_length": pkg.nd.array(vl)} if valid else {}
        with pkg.autograd.record(train_mode=False):
            if pkg is mx:
                cell.unroll(T, xs, layout="NTC", merge_outputs=True)
                _copy_weights(jcell, cell)
            else:
                jcell = cell
            out, states = cell.unroll(T, xs, layout="NTC",
                                      merge_outputs=True, **kw)
            loss = (out * pkg.nd.array(_randn(*out.shape, seed=2))).sum()
        loss.backward()
        grads = {}
        if kind in ("lstm", "gru", "rnn"):
            grads = {n[len(cell.prefix):]: p.grad().asnumpy()
                     for n, p in cell.collect_params().items()}
        res[pkg] = (out.asnumpy(), [s.asnumpy() for s in states], grads)
    (jo, js, jg), (po, ps, pg) = res[jmx], res[mx]
    _close(po, jo)
    for p, j in zip(ps, js):
        _close(p, j)
    for n in jg:
        _close_scaled(pg[n], jg[n])
    if valid:
        assert np.allclose(po[2, 1:], 0) and np.allclose(po[0, 2:], 0)


def test_gluon_cell_hybridized_unroll():
    cell = mx.gluon.rnn.LSTMCell(H)
    cell.initialize()
    x = mx.nd.array(_randn(N, T, I))
    out_e, st_e = cell.unroll(T, x, layout="NTC", merge_outputs=True)
    cell.hybridize()
    out_h, st_h = cell.unroll(T, x, layout="NTC", merge_outputs=True)
    _close(out_h.asnumpy(), out_e.asnumpy(), atol=0, rtol=0)
    for a, b in zip(st_h, st_e):
        _close(a.asnumpy(), b.asnumpy(), atol=0, rtol=0)


def test_gluon_layer_dropout_modes_and_save_load(tmp_path):
    layer = mx.gluon.rnn.GRU(H, num_layers=2, dropout=0.5,
                             bidirectional=True)
    layer.initialize()
    x = mx.nd.array(_randn(T, N, I))
    e1 = layer(x).asnumpy()
    _close(layer(x).asnumpy(), e1, atol=0, rtol=0)
    with mx.autograd.record():
        t1, t2 = layer(x).asnumpy(), layer(x).asnumpy()
    assert not np.allclose(t1, t2)
    f = str(tmp_path / "gru.params")
    layer.save_parameters(f)
    other = jmx.gluon.rnn.GRU(H, num_layers=2, dropout=0.5,
                              bidirectional=True)
    other.load_parameters(f)
    _close(other(jmx.nd.array(_randn(T, N, I))).asnumpy(), e1)
    jf = str(tmp_path / "gru_jax.params")
    other.save_parameters(jf)
    again = mx.gluon.rnn.GRU(H, num_layers=2, bidirectional=True)
    again.load_parameters(jf)
    _close(again(x).asnumpy(), e1)


def test_lm_net_trains_and_matches_jax_step():
    """Embedding -> LSTM(2 layers) -> Dense through gluon.Trainer (sgd):
    one step from the JAX net's weights gives the JAX net's weights, and
    the loss falls over a few steps."""
    v = 12
    tokens = np.random.RandomState(0).randint(0, v, (T + 1, N))
    x, y = tokens[:-1].astype(np.float32), tokens[1:].astype(np.float32)
    after = {}
    for pkg in PKGS:
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Embedding(v, 8),
                pkg.gluon.rnn.LSTM(H, num_layers=2),
                pkg.gluon.nn.Dense(v, flatten=False))
        net.initialize(pkg.init.Xavier())
        net(pkg.nd.array(x))
        if pkg is mx:
            params_from_numpy(net, w0, prefix=jprefix)
            net.hybridize()
        else:
            w0 = {p.name: p.data().asnumpy()
                  for p in net.collect_params().values()}
            jprefix = net.prefix
        # The JAX Trainer's per-parameter path, as the trainer tests use.
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5},
                                    **({"fused": False} if pkg is jmx
                                       else {}))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(4 if pkg is mx else 1):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
            trainer.step(N)
            losses.append(float(loss.mean().asscalar()))
            if len(losses) == 1:
                params = net.collect_params()
                rel = mx.gluon.utils.relative_names(list(params.keys()),
                                                    net.prefix)
                after[pkg] = {rel[n]: p.data().asnumpy()
                              for n, p in params.items()}
    assert losses[-1] < losses[0]
    assert sorted(after[mx]) == sorted(after[jmx])
    assert len(after[mx]) == 1 + 2 * 4 + 2   # embedding, 2 layers, dense
    for n, w in after[jmx].items():
        _close_scaled(after[mx][n], w)


# -- legacy symbolic cells -------------------------------------------------------

def _legacy(pkg, kind):
    if kind == "fused":
        return pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                    bidirectional=True, prefix="f_",
                                    get_next_state=True)
    seq = pkg.rnn.SequentialRNNCell()
    cls = {"lstm": pkg.rnn.LSTMCell, "gru": pkg.rnn.GRUCell,
           "rnn": pkg.rnn.RNNCell}[kind]
    seq.add(cls(H, prefix="a_"))
    seq.add(pkg.rnn.ResidualCell(cls(H, prefix="b_")))
    return seq


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "fused"])
def test_legacy_cells_bound_through_executor(kind):
    """unroll -> simple_bind, the same arguments in both packages:
    outputs and every argument's gradient."""
    x = _randn(N, T, I)
    res = {}
    for pkg in PKGS:
        out, states = _legacy(pkg, kind).unroll(
            T, pkg.sym.var("data"), layout="NTC", merge_outputs=True)
        sym = pkg.sym.Group([out] + list(states))
        if pkg is jmx:
            arg_shapes, _, _ = sym.infer_shape(data=x.shape)
            rng = np.random.RandomState(1)
            args = {n: (rng.randn(*s) * 0.4).astype(np.float32)
                    for n, s in zip(sym.list_arguments(), arg_shapes)}
            args["data"] = x
        ex = sym.bind(pkg.cpu(), {n: pkg.nd.array(v)
                                  for n, v in args.items()},
                      args_grad={n: pkg.nd.zeros(v.shape)
                                 for n, v in args.items()})
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward(out_grads=[pkg.nd.array(_randn(*o.shape, seed=3))
                               for o in outs])
        res[pkg] = (outs, {n: g.asnumpy() for n, g in ex.grad_dict.items()})
    (jo, jg), (po, pg) = res[jmx], res[mx]
    for p, j in zip(po, jo):
        _close(p, j)
    assert sorted(pg) == sorted(jg)
    for n in jg:
        _close_scaled(pg[n], jg[n])


def test_fused_cell_pack_unpack_matches_jax():
    flat = _randn(rnn_ops.rnn_param_size(2, H, I, "gru", True))
    res = []
    for pkg in PKGS:
        cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                    bidirectional=True, prefix="g_")
        unpacked = cell.unpack_weights({"g_parameters": pkg.nd.array(flat)})
        repacked = cell.pack_weights(dict(unpacked))
        res.append(({n: v.asnumpy() for n, v in unpacked.items()},
                    repacked["g_parameters"].asnumpy()))
    (ju, jr), (pu, pr) = res
    assert sorted(pu) == sorted(ju) and "g_r1_h2h_bias" in pu
    for n in ju:
        _close(pu[n], ju[n], atol=0, rtol=0)
    _close(pr, flat, atol=0, rtol=0)


def test_fused_rnn_and_lstm_bias_initializers_match_jax():
    """Seeded alike, both packages' FusedRNN and LSTMBias draw the same
    values; dumps() round-trips through create()."""
    size = rnn_ops.rnn_param_size(2, H, I, "lstm")
    got = []
    for pkg in PKGS:
        pkg.random.seed(11)
        init = pkg.init.FusedRNN(pkg.init.Uniform(0.1), num_hidden=H,
                                 num_layers=2, mode="lstm", forget_bias=1.5)
        arr = np.zeros((size,), np.float32)
        init(pkg.init.InitDesc("lstm_parameters"), arr)
        bias = np.zeros((4 * H,), np.float32)
        pkg.init.LSTMBias(0.7)(pkg.init.InitDesc("x_i2h_weight"), bias)
        got.append((arr, bias))
    _close(got[1][0], got[0][0], atol=0, rtol=0)
    _close(got[1][1], got[0][1], atol=0, rtol=0)
    for name, shape, off in rnn_ops.rnn_param_layout(2, H, I, "lstm"):
        block = got[1][0][off:off + int(np.prod(shape))].reshape(shape)
        if name.endswith("i2h_bias"):
            _close(block[H:2 * H], np.full(H, 1.5))
            _close(block[:H], np.zeros(H))
    spec = mx.init.FusedRNN(None, num_hidden=H, mode="gru").dumps()
    again = mx.init.create(spec)
    assert isinstance(again, mx.init.FusedRNN) and again._num_hidden == H
    assert again._mode == "gru"


def test_fused_rnn_relative_names():
    """FusedRNNCell's flat vector and the gluon layers' counter-based
    names match across packages by relative name."""
    layer = jmx.gluon.rnn.LSTM(H, num_layers=2)
    layer.initialize()
    layer(jmx.nd.array(_randn(T, N, I)))
    port = mx.gluon.rnn.LSTM(H, num_layers=2)
    port.initialize()
    _copy_weights(layer, port)
    _close(port(mx.nd.array(_randn(T, N, I))).asnumpy(),
           layer(jmx.nd.array(_randn(T, N, I))).asnumpy())
    rel = mx.gluon.utils.relative_names(
        ["lstm_l0_parameters", "lstm_l1_parameters", "pred_weight"])
    assert rel["lstm_l1_parameters"] == "lstm_l1_parameters"


# -- mx.rnn io and checkpoints --------------------------------------------------

def _sentences(v=20, n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, v, size=rng.choice([3, 5, 6])))
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    """Batch for batch equal: the port's iterator seeded with `s` draws
    what the JAX one draws from the global RNGs seeded with `s`."""
    import random

    sents = _sentences()
    random.seed(3)
    np.random.seed(3)
    jit = jmx.rnn.BucketSentenceIter(sents, batch_size=4, buckets=[3, 6],
                                     invalid_label=0, layout=layout)
    pit = mx.rnn.BucketSentenceIter(sents, batch_size=4, buckets=[3, 6],
                                    invalid_label=0, layout=layout, seed=3)
    assert pit.provide_data[0].shape == jit.provide_data[0].shape
    for epoch in range(2):
        jb, pb = list(jit), list(pit)
        assert len(pb) == len(jb) > 0
        for j, p in zip(jb, pb):
            assert p.bucket_key == j.bucket_key
            _close(p.data[0].asnumpy(), j.data[0].asnumpy(), atol=0)
            _close(p.label[0].asnumpy(), j.label[0].asnumpy(), atol=0)
        jit.reset()
        pit.reset()


def test_encode_sentences_matches_jax():
    words = [["a", "b", "c"], ["b", "d"], ["e", "a"]]
    assert mx.rnn.encode_sentences(words, invalid_label=0, start_label=1) \
        == jmx.rnn.encode_sentences(words, invalid_label=0, start_label=1)
    vocab = {"a": 1, "b": 2}
    got = mx.rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                  unknown_token="<unk>")
    want = jmx.rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                    unknown_token="<unk>")
    assert got == want


def _lm_sym_gen(pkg, v=20, e=6, h=8):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=v, output_dim=e,
                                  name="embed")
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.FusedRNNCell(h, num_layers=1, mode="lstm",
                                           prefix="lstm_l%d_" % i))
        out, _ = stack.unroll(seq_len, embed, layout="NTC",
                              merge_outputs=True)
        pred = pkg.sym.reshape(out, shape=(-1, h))
        pred = pkg.sym.FullyConnected(pred, num_hidden=v, name="pred")
        label = pkg.sym.reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))

    return sym_gen


def test_rnn_checkpoint_files_cross_both_ways(tmp_path):
    """save_rnn_checkpoint of either package loads in the other: the
    fused vectors unpacked to per-gate arrays on disk and packed back."""
    sym_gen = {pkg: _lm_sym_gen(pkg) for pkg in PKGS}
    sym = {pkg: sym_gen[pkg](5)[0] for pkg in PKGS}
    arg_shapes, _, _ = sym[mx].infer_shape(data=(4, 5), softmax_label=(4, 5))
    rng = np.random.RandomState(0)
    args = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(sym[mx].list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    cells = {pkg: [pkg.rnn.FusedRNNCell(8, mode="lstm",
                                        prefix="lstm_l%d_" % i)
                   for i in range(2)] for pkg in PKGS}
    for src, dst in ((mx, jmx), (jmx, mx)):
        prefix = str(tmp_path / ("from_" + src.__name__))
        src.rnn.save_rnn_checkpoint(
            cells[src], prefix, 3, sym[src],
            {n: src.nd.array(v) for n, v in args.items()}, {})
        _, on_disk, _ = src.model.load_checkpoint(prefix, 3)
        assert "lstm_l0_l0_i2h_weight" in on_disk
        assert "lstm_l0_parameters" not in on_disk
        loaded_sym, arg, aux = dst.rnn.load_rnn_checkpoint(cells[dst],
                                                           prefix, 3)
        assert sorted(arg) == sorted(args) and not aux
        for n, v in args.items():
            _close(arg[n].asnumpy(), v, atol=0, rtol=0)
        assert loaded_sym.list_arguments() == sym[dst].list_arguments()


def _batch(pkg, data, label, key):
    return pkg.io.DataBatch(
        data=[pkg.nd.array(data)], label=[pkg.nd.array(label)],
        bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", data.shape)],
        provide_label=[pkg.io.DataDesc("softmax_label", label.shape)])


def test_bucketing_lm_steps_match_jax():
    """A small LSTM LM (Embedding, two FusedRNNCell LSTM layers,
    FullyConnected, SoftmaxOutput) through BucketingModule in both
    packages from the same weights, SGD with momentum: three steps in
    buckets 6, 3 and 5, outputs and weights compared after each step.
    A step in one bucket is seen by the next (the buckets share one set
    of weights and one updater)."""
    rng = np.random.RandomState(0)
    v, b = 20, 4
    mods = {}
    for pkg in PKGS:
        mod = pkg.mod.BucketingModule(_lm_sym_gen(pkg), default_bucket_key=6,
                                      context=pkg.cpu())
        mod.bind(data_shapes=[pkg.io.DataDesc("data", (b, 6))],
                 label_shapes=[pkg.io.DataDesc("softmax_label", (b, 6))])
        mods[pkg] = mod
    mods[mx].init_params(initializer=mx.init.Xavier())
    arg0, _ = mods[mx].get_params()
    w0 = {n: a.asnumpy() for n, a in arg0.items()}
    mods[jmx].init_params(arg_params={n: jmx.nd.array(a)
                                      for n, a in w0.items()},
                          aux_params={})
    for mod in mods.values():
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "momentum": 0.9})
    prev = w0
    for key in (6, 3, 5):
        data = rng.randint(1, v, (b, key)).astype(np.float32)
        label = np.roll(data, -1, axis=1)
        label[:, -1] = 0
        got = {}
        for pkg, mod in mods.items():
            mod.forward(_batch(pkg, data, label, key), is_train=True)
            out = mod.get_outputs()[0].asnumpy()
            mod.backward()
            mod.update()
            arg, _ = mod.get_params()
            got[pkg] = (out, {n: a.asnumpy() for n, a in arg.items()})
        _close(got[mx][0], got[jmx][0], atol=1e-6)
        for n, w in got[jmx][1].items():
            _close_scaled(got[mx][1][n], w)
        moved = {n: not np.allclose(got[mx][1][n], prev[n])
                 for n in prev}
        assert moved["pred_weight"] and moved["lstm_l1_parameters"]
        prev = got[mx][1]


def test_train_rnn_lm_example_on_host():
    from mxnet_tpu_torch.examples import train_rnn_lm

    ppl = train_rnn_lm.main(["--synthetic", "--device", "cpu",
                             "--num-hidden", "8", "--num-embed", "8",
                             "--vocab-size", "30", "--num-sentences", "96",
                             "--buckets", "4,8", "--batch-size", "8",
                             "--num-epochs", "2", "--disp-batches", "100"])
    assert np.isfinite(ppl) and 1.0 < ppl < 30.0


def test_synthetic_corpus_is_small_and_structured():
    from mxnet_tpu_torch.examples.train_rnn_lm import synthetic_corpus

    sents = synthetic_corpus(10000, 50, [10, 20], seed=0)
    assert len(sents) == 50 and {len(s) for s in sents} <= {10, 20}
    flat = [w for s in sents for w in s]
    assert min(flat) >= 1 and max(flat) < 10000
    follows = {}
    for s in synthetic_corpus(50, 400, [10], seed=1):
        for a, c in zip(s, s[1:]):
            follows.setdefault(a, set()).add(c)
    assert max(len(f) for f in follows.values()) <= 4


@pytest.mark.cuda
def test_rnn_op_on_card_matches_host():
    """The RNN op and its gradients on the card against the host (TF32
    off), LSTM and GRU, two bidirectional layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for mode in ("lstm", "gru"):
        arrays = _rnn_inputs(mode, 2, True)
        res = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            nds = [mx.nd.array(a, ctx=ctx) for a in arrays]
            for a in nds:
                a.attach_grad()
            with mx.autograd.record():
                out = mx.nd.RNN(*nds, state_size=H, num_layers=2, mode=mode,
                                bidirectional=True)
                (out * out).sum().backward()
            res.append([out.asnumpy()] + [a.grad.asnumpy() for a in nds])
        for c, h in zip(res[1], res[0]):
            _close_scaled(c, h)
