"""``gluon.contrib`` and ``contrib.io`` of the port against the JAX
package's, on the same numpy inputs, weights crossing as numpy
(``gluon.utils.params_from_numpy``).

- ``Concurrent``, ``HybridConcurrent`` (hybridized too) and ``Identity``;
- the nine ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``\\ s unrolled 3 steps:
  outputs, states and every weight's gradient (one parametrised test);
- ``LSTMPCell`` unrolled, and ``VariationalDropoutCell`` at drop rate 0,
  and at state-drop rate 0.5 with one mask injected into both sides,
  outputs and gradients; with dropout on the port, one mask for every
  time step (RNG positions do not cross packages);
- ``NCELoss``: the loss and its gradients;
- ``IntervalSampler`` and ``DataLoaderIter``'s batches;
- ``SparseEmbedding``: one ``gluon.Trainer`` Adam step moves exactly the
  batch's rows (the lazy row-sparse path), as the JAX package's does;
- ``SyncBatchNorm`` in the dp ``TrainStep`` over two gloo ranks against
  the JAX package's dp mesh (tests/torch_contrib_prog.py, started by
  tests/torch_dist_prog.py's launcher).

Tolerances: float32 on both sides, different summation orders
(XLA's convolutions and GEMMs against torch's): rtol 1e-5 and an atol of
1e-5 of each tensor's largest magnitude; the dp step is held to
tests/test_torch_dist_train_step.py's (rtol 1e-5, atol 1e-4 of the
largest magnitude). Where the same elementwise ops run in the same
order the values agree far closer than that.
"""
import os

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import contrib as jcontrib
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

from torch_dist_prog import launch

torch.set_num_threads(2)

C = mx.cpu()
RTOL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=RTOL * max(float(np.abs(want).max()), 1e-6), err_msg=what)


def _copy(tnet, jnet):
    params_from_numpy(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()},
                      prefix=jnet.prefix)


def _grads(net):
    rel = relative_names(list(net.collect_params()), net.prefix)
    return {rel[n]: p.grad().asnumpy()
            for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def _hold_grads(tnet, jnet):
    got, want = _grads(tnet), _grads(jnet)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


# -- nn -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent",
                                  "HybridConcurrent_hybridized"])
def test_concurrent_and_identity_match_jax(kind):
    cls = kind.split("_")[0]
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)

    def build(m, cnn):
        net = getattr(cnn, cls)(axis=-1)
        net.add(m.gluon.nn.Dense(4, in_units=3))
        net.add(cnn.Identity())
        net.add(m.gluon.nn.Dense(2, in_units=3, activation="tanh"))
        return net

    jnet = build(jmx, jcontrib.nn)
    jnet.initialize()
    with mx.cpu():
        tnet = build(mx, tcontrib.nn)
        tnet.initialize(ctx=C)
    _copy(tnet, jnet)
    if kind.endswith("hybridized"):
        tnet.hybridize()
        jnet.hybridize()
    outs = []
    for m, net, ctx in ((jmx, jnet, jmx.cpu()), (mx, tnet, C)):
        xa = m.nd.array(x, ctx=ctx)
        with m.autograd.record():
            y = net(xa)
            (y * y).sum().backward()
        outs.append(y.asnumpy())
    assert outs[1].shape == (5, 9)
    _close(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][:, 4:7], x)
    _hold_grads(tnet, jnet)


# -- rnn ----------------------------------------------------------------------

SPATIAL = {1: (6,), 2: (5, 5), 3: (3, 4, 4)}


def _unrolled(m, cell, seq, ctx, steps=3):
    x = m.nd.array(seq, ctx=ctx)
    with m.autograd.record():
        outputs, states = cell.unroll(steps, x, merge_outputs=True)
        loss = (outputs * outputs).mean() + sum(
            (s * s).mean() for s in states)
    loss.backward()
    return outputs.asnumpy(), [s.asnumpy() for s in states]


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_conv_rnn_cells_match_jax(kind, dims):
    name = "Conv%dD%sCell" % (dims, kind)
    in_shape = (2,) + SPATIAL[dims]
    kw = dict(hidden_channels=3, i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    jcell = getattr(jcontrib.rnn, name)(in_shape, **kw)
    jcell.initialize(jmx.init.Xavier())
    with mx.cpu():
        tcell = getattr(tcontrib.rnn, name)(in_shape, **kw)
        tcell.initialize(ctx=C)
    rng = np.random.RandomState(dims * 7 + len(kind))
    for p in jcell.collect_params().values():
        if p.name.endswith("bias"):
            p.set_data(jmx.nd.array(rng.uniform(-0.2, 0.2, p.shape)
                                    .astype(np.float32)))
    _copy(tcell, jcell)
    seq = rng.randn(2, 3, *in_shape).astype(np.float32)      # N T C ...
    want = _unrolled(jmx, jcell, seq, jmx.cpu())
    got = _unrolled(mx, tcell, seq, C)
    assert got[0].shape == (2, 3, 3) + SPATIAL[dims]
    _close(got[0], want[0], "outputs")
    assert len(got[1]) == len(want[1]) == (2 if kind == "LSTM" else 1)
    for g, w in zip(got[1], want[1]):
        _close(g, w, "states")
    _hold_grads(tcell, jcell)


def _lstmp(m):
    return jcontrib.rnn.LSTMPCell(12, 5, input_size=4) if m is jmx \
        else tcontrib.rnn.LSTMPCell(12, 5, input_size=4)


def test_lstmp_cell_matches_jax():
    jcell = _lstmp(jmx)
    jcell.initialize(jmx.init.Xavier())
    with mx.cpu():
        tcell = _lstmp(mx)
        tcell.initialize(ctx=C)
    _copy(tcell, jcell)
    seq = np.random.RandomState(1).randn(3, 6, 4).astype(np.float32)
    want = _unrolled(jmx, jcell, seq, jmx.cpu(), 6)
    got = _unrolled(mx, tcell, seq, C, 6)
    assert got[0].shape == (3, 6, 5)
    assert [s.shape for s in got[1]] == [(3, 5), (3, 12)]
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
    _hold_grads(tcell, jcell)


@pytest.mark.parametrize("path", ["unroll", "steps"])
def test_variational_dropout_at_rate_zero_matches_jax(path):
    def build(m, crnn, ctx):
        cell = crnn.VariationalDropoutCell(
            m.gluon.rnn.LSTMCell(8, input_size=6), drop_inputs=0.0,
            drop_states=0.0, drop_outputs=0.0)
        cell.initialize(ctx=ctx)
        return cell

    jcell = build(jmx, jcontrib.rnn, jmx.cpu())
    with mx.cpu():
        tcell = build(mx, tcontrib.rnn, C)
    _copy(tcell, jcell)
    seq = np.random.RandomState(2).randn(2, 5, 6).astype(np.float32)
    if path == "unroll":
        want = _unrolled(jmx, jcell, seq, jmx.cpu(), 5)
        got = _unrolled(mx, tcell, seq, C, 5)
        _close(got[0], want[0])
    else:
        outs = []
        for m, cell, ctx in ((jmx, jcell, jmx.cpu()), (mx, tcell, C)):
            states = cell.begin_state(batch_size=2, ctx=ctx) \
                if m is mx else cell.begin_state(batch_size=2)
            with m.autograd.record():
                total = 0
                for t in range(5):
                    y, states = cell(m.nd.array(seq[:, t], ctx=ctx), states)
                    total = total + (y * y).sum()
            total.backward()
            outs.append(y.asnumpy())
        _close(outs[1], outs[0])
    _hold_grads(tcell, jcell)


def _state_cell(m, kind):
    if kind == "lstmp":
        return _lstmp(m)
    return {"rnn": m.gluon.rnn.RNNCell, "gru": m.gluon.rnn.GRUCell,
            "lstm": m.gluon.rnn.LSTMCell}[kind](5, input_size=4)


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm", "lstmp"])
def test_variational_state_dropout_with_injected_mask(kind):
    """State dropout at rate 0.5 with one 0/2 mask injected into both
    sides (RNG positions do not cross packages). A single-state cell
    (RNN, GRU) is held against the JAX package's VariationalDropoutCell.
    An LSTM or LSTMP cell is held against the JAX package's bare cell
    stepped with only h masked, as upstream masks it: the JAX package's
    VariationalDropoutCell multiplies every state by h's mask, which
    drops an LSTM's cell state too and fails on LSTMP's shapes."""
    rng = np.random.RandomState(4)
    seq = rng.randn(3, 4, 4).astype(np.float32)
    mask = (rng.rand(3, 5) < 0.5).astype(np.float32) * 2.0
    single = kind in ("rnn", "gru")
    jbase = _state_cell(jmx, kind)
    jbase.initialize(jmx.init.Xavier())
    jcell = jcontrib.rnn.VariationalDropoutCell(jbase, drop_states=0.5) \
        if single else jbase
    with mx.cpu():
        tcell = tcontrib.rnn.VariationalDropoutCell(_state_cell(mx, kind),
                                                    drop_states=0.5)
        tcell.initialize(ctx=C)
    _copy(tcell.base_cell, jbase)
    res = []
    for m, cell, ctx in ((jmx, jcell, jmx.cpu()), (mx, tcell, C)):
        states = jcell.begin_state(batch_size=3) if m is jmx else \
            tcell.begin_state(batch_size=3, ctx=ctx)
        h_mask = m.nd.array(mask, ctx=ctx)
        if cell is not jbase:
            cell._state_mask = h_mask
        with m.autograd.record():
            total = 0
            for t in range(4):
                if cell is jbase:      # upstream's h-only state dropout
                    states = [states[0] * h_mask] + list(states[1:])
                y, states = cell(m.nd.array(seq[:, t], ctx=ctx), states)
                total = total + (y * y).sum()
        total.backward()
        res.append((y.asnumpy(), [s.asnumpy() for s in states]))
        if cell is not jbase:
            np.testing.assert_array_equal(cell._state_mask.asnumpy(), mask)
    (wy, ws), (gy, gs) = res
    _close(gy, wy, "output")
    assert len(gs) == len(ws) == (1 if single else 2)
    for g, w in zip(gs, ws):
        _close(g, w, "states")
    _hold_grads(tcell.base_cell, jbase)


def test_variational_dropout_keeps_one_mask_across_time():
    """With dropout on, the output mask of an unroll is one draw shared
    by every step (the zeros of each (n, c) are the same at every t),
    and the per-step path draws its input mask once per sequence."""
    with mx.cpu():
        base = mx.gluon.rnn.LSTMCell(16, input_size=6)
        cell = tcontrib.rnn.VariationalDropoutCell(
            base, drop_inputs=0.5, drop_states=0.5, drop_outputs=0.5)
        cell.initialize(ctx=C)
        seq = mx.nd.array(np.random.RandomState(3).rand(4, 7, 6)
                          .astype(np.float32) + 0.5, ctx=C)
        with mx.autograd.record():
            out, _ = cell.unroll(7, seq, merge_outputs=True)
        zero = out.asnumpy() == 0                      # (N, T, C)
        assert zero.any() and not zero.all()
        assert (zero == zero[:, :1, :]).all()
        cell.reset()
        states = cell.begin_state(batch_size=4, ctx=C)
        masks = []
        with mx.autograd.record():
            for t in range(4):
                _, states = cell(seq[:, t], states)
                masks.append(cell._input_mask.asnumpy())
        assert set(np.unique(masks[0])) == {0.0, 2.0}
        for m in masks[1:]:
            np.testing.assert_array_equal(m, masks[0])


# -- loss, data, io -----------------------------------------------------------

def test_nce_loss_matches_jax():
    rng = np.random.RandomState(4)
    B, D, V, k = 6, 8, 50, 5
    arrays = {"embed": rng.randn(B, D).astype(np.float32),
              "weight": rng.randn(V, D).astype(np.float32) * 0.3,
              "bias": rng.randn(V).astype(np.float32) * 0.1,
              "label": rng.randint(0, V, B).astype(np.float32),
              "noise": rng.randint(0, V, (B, k)).astype(np.float32)}
    res = []
    for m, loss_cls, ctx in ((jmx, jcontrib.loss.NCELoss, jmx.cpu()),
                             (mx, tcontrib.loss.NCELoss, C)):
        a = {n: m.nd.array(v, ctx=ctx) for n, v in arrays.items()}
        for n in ("embed", "weight", "bias"):
            a[n].attach_grad()
        with m.autograd.record():
            loss = loss_cls(num_sampled=k, num_classes=V)(
                a["embed"], a["weight"], a["bias"], a["label"], a["noise"])
        loss.backward()
        res.append([loss.asnumpy()] + [a[n].grad.asnumpy()
                                       for n in ("embed", "weight", "bias")])
    assert res[1][0].shape == (B,)
    for g, w in zip(res[1], res[0]):
        _close(g, w)


def test_interval_sampler_matches_jax():
    for length, interval, rollover in ((10, 3, True), (10, 3, False),
                                       (7, 7, True), (9, 1, False)):
        t = tcontrib.data.IntervalSampler(length, interval, rollover)
        j = jcontrib.data.IntervalSampler(length, interval, rollover)
        assert list(t) == list(j) and len(t) == len(j)
    assert list(tcontrib.data.IntervalSampler(10, 3)) == \
        [0, 3, 6, 9, 1, 4, 7, 2, 5, 8]


def test_data_loader_iter_batches_match_jax():
    from mxnet_tpu.contrib.io import DataLoaderIter as JIter
    from mxnet_tpu_torch.contrib.io import DataLoaderIter as TIter

    rng = np.random.RandomState(5)
    X = rng.rand(10, 3, 4).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    with mx.cpu():
        tit = TIter(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(X, y), batch_size=4))
    jit = JIter(jmx.gluon.data.DataLoader(
        jmx.gluon.data.ArrayDataset(X, y), batch_size=4))
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data] == [("data", (4, 3, 4))]
    assert [tuple(d) for d in tit.provide_label] == [("softmax_label", (4,))]
    assert tit.batch_size == jit.batch_size == 4
    for epoch in range(2):
        with mx.cpu():    # the loader makes its arrays as it iterates
            got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in tit]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in jit]
        assert len(got) == len(want) == 3
        for (gd, gl), (wd, wl) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
        tit.reset()
        jit.reset()
    with mx.cpu():
        batch = next(iter(TIter(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(X, y), batch_size=4))))
    assert batch.data[0].context == C and batch.label[0].context == C


def test_data_loader_iter_reset_first_serves_the_loaders_batches():
    """A reset before the first next (Module.score/predict reset first)
    serves exactly the loader's batches, each once, as upstream's
    iterator does after its own reset in __init__."""
    from mxnet_tpu_torch.contrib.io import DataLoaderIter as TIter

    rng = np.random.RandomState(7)
    X = rng.rand(12, 3, 4).astype(np.float32)
    y = np.arange(12, dtype=np.float32)
    with mx.cpu():
        loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(X, y),
                                          batch_size=4)
        want = [(d.asnumpy(), l.asnumpy()) for d, l in loader]
        it = TIter(loader)
        for _ in range(2):
            it.reset()
            got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
            assert len(got) == len(want) == 3
            for (gd, gl), (wd, wl) in zip(got, want):
                np.testing.assert_array_equal(gd, wd)
                np.testing.assert_array_equal(gl, wl)
        # Module.predict over a fresh iterator returns one row a sample.
        data = mx.sym.var("data")
        net = mx.sym.FullyConnected(mx.sym.flatten(data), num_hidden=2,
                                    name="fc")
        mod = mx.mod.Module(net, label_names=None, context=C)
        mod.bind(data_shapes=TIter(loader).provide_data,
                 for_training=False)
        mod.init_params()
        assert mod.predict(TIter(loader)).shape == (12, 2)


def test_sparse_embedding_adam_moves_only_the_batch_rows():
    rng = np.random.RandomState(6)
    table = rng.randn(20, 6).astype(np.float32)
    ids = np.array([1, 3, 1, 7], np.float32)
    res = []
    for m, cnn, ctx in ((jmx, jcontrib.nn, jmx.cpu()), (mx, tcontrib.nn, C)):
        emb = cnn.SparseEmbedding(20, 6)
        emb.initialize(ctx=ctx)
        assert emb.weight.grad_stype == "row_sparse"
        emb.weight.set_data(m.nd.array(table, ctx=ctx))
        trainer = m.gluon.Trainer(emb.collect_params(), "adam",
                                  {"learning_rate": 0.1})
        x = m.nd.array(ids, ctx=ctx)
        with m.autograd.record():
            loss = (emb(x) * m.nd.array(np.arange(6, dtype=np.float32) + 1,
                                        ctx=ctx)).sum()
        loss.backward()
        trainer.step(4)
        res.append(emb.weight.data().asnumpy())
    moved = np.where((res[1] != table).any(axis=1))[0]
    assert sorted(moved) == [1, 3, 7]
    np.testing.assert_array_equal(np.delete(res[1], moved, 0),
                                  np.delete(table, moved, 0))
    _close(res[1], res[0])


def test_sync_batchnorm_is_a_batchnorm_on_one_device():
    with mx.cpu():
        bn = tcontrib.nn.SyncBatchNorm(in_channels=4, num_devices=8)
        bn.initialize(ctx=C)
        ref = mx.gluon.nn.BatchNorm(in_channels=4)
        ref.initialize(ctx=C)
        x = mx.nd.array(np.random.RandomState(7).rand(2, 4, 3, 3)
                        .astype(np.float32), ctx=C)
        with mx.autograd.record():
            a, b = bn(x), ref(x)
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert isinstance(bn, mx.gluon.nn.BatchNorm)


def test_sync_batchnorm_in_the_dp_step_matches_jax_dp_mesh(tmp_path):
    """Two gloo ranks, each fed its half of a batch whose halves have
    different means: the port's dp TrainStep (global BatchNorm moments
    through ``batch_stat_reducer``) against the JAX package's step over a
    two-device dp mesh, three SGD-momentum steps."""
    from mxnet_tpu.parallel import TrainStep as JTrainStep
    from mxnet_tpu.parallel import make_mesh as jmake_mesh

    import torch_contrib_prog as prog

    rng = np.random.RandomState(8)
    jnet = prog.dense_syncbn_dense(jmx)
    jmx.random.seed(8)
    jnet.initialize()
    with jmx.autograd.pause():
        jnet(jmx.nd.array(rng.rand(8, 4).astype(np.float32)))
    for name, p in jnet.collect_params().items():
        if name.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "bias")):
            # a bias before BatchNorm has no gradient in exact arithmetic:
            # away from zero, its rounding noise stays below the atol
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
    shift = np.repeat(np.array([0.0, 2.0], np.float32), 4)
    xs = rng.rand(3, 8, 4).astype(np.float32) * 3 - 1 + shift[None, :, None]
    ys = rng.randint(0, 2, (3, 8)).astype(np.float32)
    weights = {"w:" + k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    np.savez(tmp_path / "data.npz", x=xs, y=ys, prefix=jnet.prefix,
             **weights)
    launch(2, 0, "syncbn", tmp_path, data=tmp_path / "data.npz",
           prog=os.path.abspath(prog.__file__))
    step = JTrainStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(prog.OPT), mesh=jmake_mesh(
                          {"dp": 2}, devices=jax.devices()[:2]))
    want_losses = np.array([float(jax.device_get(step(x, y)))
                            for x, y in zip(xs, ys)], np.float32)
    params, opt_state, aux = step.state_to_host()
    rel = relative_names(list(params) + list(aux), jnet.prefix)
    want = {}
    for n, v in params.items():
        want["p:" + rel[n]] = np.asarray(v)
        want["m:" + rel[n]] = np.asarray(opt_state[n][0])
    for n, v in aux.items():
        want["a:" + rel[n]] = np.asarray(v)
    outs = [dict(np.load(tmp_path / ("syncbn_r%d.npz" % r)))
            for r in range(2)]
    for out in outs:
        np.testing.assert_allclose(out["loss"], want_losses, rtol=1e-5,
                                   atol=1e-6)
        for name, w in want.items():
            np.testing.assert_allclose(
                out[name], w, rtol=1e-5,
                atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=name)
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
