"""The port's sparse path against the JAX package's.

Same numpy inputs (from a seed) through both packages' sparse arrays,
``.params`` records, ``LibSVMIter``, local stores, ``sparse.dot``,
lazy row-sparse SGD and Adam, the Trainer's row-sparse step and the
matrix factorization example. Tolerances:

- construction, casts, ``retain``, row gathers, files, the iterator and
  store pulls move values without arithmetic: bit for bit;
- ``sparse.dot`` sums in another order (``index_add_`` against XLA's
  segment sum): float32 within rtol 1e-5, atol 1e-6;
- optimizer rows: rtol 1e-6, atol 1e-7 (XLA may contract ``a*b+c`` into
  one FMA on the host, ROADMAP Queue 3); rows the lazy update must not
  touch, and their moments, bit for bit their start;
- three matrix factorization steps through each package's Trainer:
  rtol 1e-5, atol 1e-6.

The JAX package pads ``dense_to_rsp_device``'s rows with out-of-range
ids; the port does not, and its result is compared with the JAX one
after those ids are dropped.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.examples import train_matrix_factorization as mf
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names
from mxnet_tpu_torch.ndarray import sparse as sp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
DOT_TOL = dict(rtol=1e-5, atol=1e-6)
MF_TOL = dict(rtol=1e-5, atol=1e-6)


def _rows_dense(seed, shape=(9, 4), keep=0.5):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape).astype(np.float32)
    d[rng.rand(shape[0]) >= keep] = 0.0
    return d


def _csr_dense(seed, shape=(9, 6), density=0.3):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * (rng.rand(*shape) < density)) \
        .astype(np.float32)


def _same_rsp(got, want):
    assert got.stype == want.stype == "row_sparse"
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  np.asarray(want.indices.asnumpy()))
    np.testing.assert_array_equal(got.data.asnumpy(), want.data.asnumpy())
    assert got.data.asnumpy().dtype == want.data.asnumpy().dtype


def _same_csr(got, want):
    assert got.stype == want.stype == "csr"
    assert got.shape == tuple(want.shape)
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        np.testing.assert_array_equal(a.asnumpy(), np.asarray(b.asnumpy()))


# -- arrays -------------------------------------------------------------------

def test_row_sparse_array_from_dense_and_tuple_matches_jax():
    d = _rows_dense(0)
    with CPU:
        got = sp.row_sparse_array(d)
        assert got.context == CPU and got.indices.asnumpy().dtype == np.int64
        _same_rsp(got, jsp.row_sparse_array(d))
        np.testing.assert_array_equal(got.todense().asnumpy(), d)
        vals = np.arange(6, dtype=np.float32).reshape(3, 2)
        ids = np.array([4, 0, 7])
        got = sp.row_sparse_array((vals, ids), shape=(8, 2))
        want = jsp.row_sparse_array((vals, ids), shape=(8, 2))
        _same_rsp(got, want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_csr_matrix_from_dense_and_tuple_matches_jax():
    d = _csr_dense(1)
    d[4] = 0.0                                   # an empty row
    with CPU:
        got, want = sp.csr_matrix(d), jsp.csr_matrix(d)
        _same_csr(got, want)
        np.testing.assert_array_equal(got.todense().asnumpy(), d)
        got = sp.csr_matrix((want.data.asnumpy(), want.indices.asnumpy(),
                             want.indptr.asnumpy()), shape=d.shape)
        _same_csr(got, want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_and_tostype_match_jax(stype):
    d = _rows_dense(2, (7, 5)) * (_csr_dense(3, (7, 5)) != 0)
    with CPU:
        x = mx.nd.array(d)
        got, want = x.tostype(stype), jmx.nd.array(d).tostype(stype)
        (_same_rsp if stype == "row_sparse" else _same_csr)(got, want)
        assert got.context == CPU
        assert sp.cast_storage(got, stype) is got
        back = sp.cast_storage(got, "default")
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), d)
        x64 = mx.nd.array(d, dtype="float64").tostype(stype)
        assert x64.data.asnumpy().dtype == np.float64   # kept 64-bit


def test_zeros_and_retain_match_jax():
    with CPU:
        for stype, shape in (("row_sparse", (5, 3)), ("csr", (4, 6))):
            got, want = sp.zeros(stype, shape), jsp.zeros(stype, shape)
            assert got.shape == shape and got.stype == stype
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
            np.testing.assert_array_equal(got.indices.asnumpy(),
                                          want.indices.asnumpy())
        d = _rows_dense(4, (10, 3), keep=0.7)
        keep = np.array([9, 2, 3, 5])
        got = sp.retain(sp.row_sparse_array(d), mx.nd.array(keep,
                                                            dtype="int64"))
        _same_rsp(got, jsp.retain(jsp.row_sparse_array(d),
                                  jmx.nd.array(keep, dtype="int64")))


def test_gather_rows_unsorted_and_empty_match_jax():
    vals = np.array([[10., 11.], [20., 21.], [-3., 4.]], np.float32)
    ids = np.array([5, 1, 7])
    want_ids = np.array([1, 5, 0, 7, 5])
    with CPU:
        got = sp._gather_rows(sp.row_sparse_array((vals, ids), shape=(8, 2)),
                              want_ids)
        want = jsp._gather_rows(jsp.row_sparse_array((vals, ids),
                                                     shape=(8, 2)), want_ids)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        empty = sp._gather_rows(sp.zeros("row_sparse", (4, 2)), [0, 3])
        np.testing.assert_array_equal(
            empty.asnumpy(),
            jsp._gather_rows(jsp.zeros("row_sparse", (4, 2)),
                             [0, 3]).asnumpy())


def test_aggregate_rows_matches_jax():
    rng = np.random.RandomState(22)
    vals = rng.randn(7, 3).astype(np.float32)
    ids = np.array([4, 1, 4, 9, 1, 4, 0])
    got = sp._aggregate_rows_np(vals, ids, (3,))
    want = jsp._aggregate_rows_np(vals, ids, (3,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert sp._aggregate_rows_np(vals.astype(np.float64), ids,
                                 (3,))[1].dtype == np.float64


def test_as_in_context_keeps_sparsity_and_copy_is_deep():
    with CPU:
        rsp = sp.row_sparse_array((np.ones((2, 3), np.float32),
                                   np.array([1, 4])), shape=(6, 3))
        moved = rsp.as_in_context(mx.cpu(1))
        assert isinstance(moved, sp.RowSparseNDArray)
        assert moved.context == mx.cpu(1) and moved.indices.shape == (2,)
        dup = rsp.copy()
        dup._data.add_(1.0)
        np.testing.assert_array_equal(rsp.data.asnumpy(), 1.0)
        csr = sp.csr_matrix(_csr_dense(5))
        assert isinstance(csr.as_in_context(mx.cpu(1)), sp.CSRNDArray)


def test_dense_to_rsp_device_equals_jax_without_pad_ids():
    d = np.zeros((8, 3), np.float32)
    d[2], d[5], d[6] = 1.5, -2.0, 0.25
    with CPU:
        for dense in (d, np.zeros((4, 2), np.float32), _rows_dense(6)):
            got = sp.dense_to_rsp_device(mx.nd.array(dense))
            want = jsp.dense_to_rsp_device(jmx.nd.array(dense))
            assert got._rows_ready and got.stype == "row_sparse"
            ids = np.asarray(want.indices.asnumpy())
            real = ids < dense.shape[0]
            np.testing.assert_array_equal(got.indices.asnumpy(), ids[real])
            np.testing.assert_array_equal(got.data.asnumpy(),
                                          want.data.asnumpy()[real])
            np.testing.assert_array_equal(got.todense().asnumpy(), dense)


# -- dot ------------------------------------------------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_csr_dense_matches_jax(transpose_a):
    d = _csr_dense(7, (13, 9))
    rng = np.random.RandomState(8)
    rhs = rng.randn(13 if transpose_a else 9, 5).astype(np.float32)
    with CPU:
        got = sp.dot(sp.csr_matrix(d), mx.nd.array(rhs),
                     transpose_a=transpose_a)
        want = jsp.dot(jsp.csr_matrix(d), jmx.nd.array(rhs),
                       transpose_a=transpose_a)
        assert got.shape == want.shape and got.context == CPU
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **DOT_TOL)
        if not transpose_a:                      # the method form
            np.testing.assert_array_equal(
                sp.csr_matrix(d).dot(mx.nd.array(rhs)).asnumpy(),
                got.asnumpy())


def test_dot_vector_and_fallback_match_jax():
    m = np.array([[1., 0., 2.], [0., 3., 0.]], np.float32)
    with CPU:
        for rhs, ta in ((np.ones(3, np.float32), False),
                        (np.array([1., 2.], np.float32), True)):
            got = sp.dot(sp.csr_matrix(m), mx.nd.array(rhs), transpose_a=ta)
            want = jsp.dot(jsp.csr_matrix(m), jmx.nd.array(rhs),
                           transpose_a=ta)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                       **DOT_TOL)
        # row_sparse x dense densifies and takes the dense dot
        d = _rows_dense(9, (4, 3))
        rhs = np.random.RandomState(10).randn(3, 2).astype(np.float32)
        got = sp.dot(sp.row_sparse_array(d), mx.nd.array(rhs))
        want = jsp.dot(jsp.row_sparse_array(d), jmx.nd.array(rhs))
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **DOT_TOL)


def test_sparse_linear_model_converges():
    """tests/test_sparse_compute.py's sparse logistic regression on the
    port: CSR batches from LibSVMIter, gradients by dot(csr.T, resid)."""
    rng = np.random.RandomState(0)
    n, d = 200, 60
    dense = (rng.rand(n, d) * (rng.rand(n, d) < 0.15)).astype(np.float32)
    w_true = rng.randn(d).astype(np.float32)
    y = (dense @ w_true > 0).astype(np.float32)
    path = _write_libsvm(dense, y)
    try:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(d,),
                              batch_size=50, ctx=CPU)
        with CPU:
            w, bias = mx.nd.zeros((d, 1)), mx.nd.zeros((1,))
            losses = []
            for _ in range(50):
                it.reset()
                total, count = 0.0, 0
                for batch in it:
                    xb = batch.data[0]
                    yb = batch.label[0].reshape((-1, 1))
                    p = (sp.dot(xb, w) + bias).sigmoid()
                    loss = -(yb * (p + 1e-7).log()
                             + (1 - yb) * (1 - p + 1e-7).log()).mean()
                    resid = (p - yb) / xb.shape[0]
                    w -= 2.0 * sp.dot(xb, resid, transpose_a=True)
                    bias -= 2.0 * resid.sum()
                    total += float(loss.asnumpy())
                    count += 1
                losses.append(total / count)
    finally:
        os.unlink(path)
    assert losses[-1] < losses[0] * 0.5, losses[::7]
    pred = dense @ w.asnumpy().ravel() + float(bias.asnumpy()[0]) > 0
    assert (pred == (y > 0)).mean() > 0.9


# -- files ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_files_byte_identical_and_cross_loaded(tmp_path, writer):
    d_rsp, d_csr = _rows_dense(11, (6, 3)), _csr_dense(12, (5, 7))
    dense = np.random.RandomState(13).randn(2, 3).astype(np.float32)
    jfile, pfile = str(tmp_path / "j.params"), str(tmp_path / "p.params")
    jmx.nd.save(jfile, {"rsp": jsp.row_sparse_array(d_rsp),
                        "csr": jsp.csr_matrix(d_csr),
                        "w": jmx.nd.array(dense)})
    with CPU:
        mx.nd.save(pfile, {"rsp": sp.row_sparse_array(d_rsp),
                           "csr": sp.csr_matrix(d_csr),
                           "w": mx.nd.array(dense)})
    assert open(jfile, "rb").read() == open(pfile, "rb").read()
    src = jfile if writer == "jax" else pfile
    got = mx.nd.load(src, ctx=CPU)
    want = jmx.nd.load(src)
    _same_rsp(got["rsp"], want["rsp"])
    _same_csr(got["csr"], want["csr"])
    assert got["rsp"].context == CPU
    np.testing.assert_array_equal(got["w"].asnumpy(), dense)


# -- LibSVMIter -----------------------------------------------------------------

def _write_libsvm(dense, labels, path=None):
    import tempfile

    if path is None:
        fd, path = tempfile.mkstemp(suffix=".libsvm")
        os.close(fd)
    with open(path, "w") as f:
        for row, lab in zip(dense, labels):
            cols = np.nonzero(row)[0]
            f.write("%g %s\n" % (lab, " ".join("%d:%r" % (c, float(row[c]))
                                              for c in cols)))
    return path


def test_libsvm_iter_batches_match_jax(tmp_path):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        # unsorted columns, a repeated column and an explicit zero
        f.write("1 3:2.5 0:1.5\n0 1:1.0 1:4.0\n1 2:3.0 4:0\n"
                "0\n1 4:-1.25 2:0.5\n2 0:7\n0 3:1e-3\n")
    got = list(mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                batch_size=3, ctx=CPU))
    want = list(jmx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                  batch_size=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.data[0].context == CPU
        _same_csr(g.data[0], w.data[0])
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
        assert g.pad == w.pad
    assert got[-1].pad == 2
    assert mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                            batch_size=3, ctx=CPU).provide_data[0].shape \
        == (3, 5)


def test_ndarray_iter_takes_a_sparse_array():
    with CPU:
        d = _csr_dense(14, (6, 4))
        it = mx.io.NDArrayIter(sp.csr_matrix(d), np.arange(6), batch_size=3,
                               ctx=CPU)
        batches = [b.data[0].asnumpy() for b in it]
    np.testing.assert_array_equal(np.concatenate(batches), d)


# -- kvstore --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "device"])
def test_row_sparse_pull_into_dense_and_row_sparse_outs_match_jax(kind):
    w = np.arange(12).reshape(6, 2).astype(np.float32)
    rows = np.array([0, 2], np.int64)
    init = np.arange(6, dtype=np.float32).reshape(3, 2)
    init_ids = np.array([5, 0, 2])
    jkv, kv = jmx.kv.create(kind), mx.kv.create(kind)
    with CPU:
        jkv.init("emb", jmx.nd.array(w))
        kv.init("emb", mx.nd.array(w))
        jout, out = jmx.nd.zeros((6, 2)), mx.nd.zeros((6, 2))
        jkv.row_sparse_pull("emb", out=jout,
                            row_ids=jmx.nd.array(rows, dtype="int64"))
        kv.row_sparse_pull("emb", out=out,
                           row_ids=mx.nd.array(rows, dtype="int64"))
        np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
        small = mx.nd.zeros((2, 2))
        kv.row_sparse_pull("emb", out=small,
                           row_ids=mx.nd.array(rows, dtype="int64"))
        np.testing.assert_array_equal(small.asnumpy(), w[rows])
        # a row-sparse store: absent rows are zeros, no densification
        jkv.init("rsp", jsp.row_sparse_array((init, init_ids),
                                             shape=(8, 2)))
        kv.init("rsp", sp.row_sparse_array((init, init_ids), shape=(8, 2)))
        req = np.array([0, 3, 5], np.int64)
        jo, o = jsp.zeros("row_sparse", (3, 2)), sp.zeros("row_sparse",
                                                          (3, 2))
        jkv.row_sparse_pull("rsp", out=jo, row_ids=jmx.nd.array(
            req, dtype="int64"))
        kv.row_sparse_pull("rsp", out=o, row_ids=mx.nd.array(
            req, dtype="int64"))
        assert isinstance(o, sp.RowSparseNDArray) and o.shape == (8, 2)
        _same_rsp(o, jo)


def test_row_sparse_push_merges_duplicates_and_updates_lazily():
    vals = np.random.RandomState(15).randn(3, 2).astype(np.float32)
    ids = [np.array([1, 4, 1]), np.array([4, 6, 1])]
    jkv, kv = jmx.kv.create("local"), mx.kv.create("local")
    for k, opt in ((jkv, jmx.optimizer.SGD(learning_rate=1.0)),
                   (kv, mx.optimizer.SGD(learning_rate=1.0))):
        k.set_optimizer(opt)
    with CPU:
        w0 = np.random.RandomState(16).randn(8, 2).astype(np.float32)
        jkv.init("w", jmx.nd.array(w0))
        kv.init("w", mx.nd.array(w0))
        jkv.push("w", [jsp.row_sparse_array((vals, i), shape=(8, 2))
                       for i in ids])
        kv.push("w", [sp.row_sparse_array((vals, i), shape=(8, 2))
                      .as_in_context(mx.cpu(1)) for i in ids])
        jout, out = jmx.nd.zeros((8, 2)), mx.nd.zeros((8, 2))
        jkv.pull("w", out=jout)
        kv.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **OPT_TOL)
    untouched = [0, 2, 3, 5, 7]
    np.testing.assert_array_equal(out.asnumpy()[untouched], w0[untouched])
    merged = kv._merge([sp.row_sparse_array((vals, i), shape=(8, 2),
                                            ctx=CPU) for i in ids])
    np.testing.assert_array_equal(merged.indices.asnumpy(), [1, 4, 6])


# -- optimizers -----------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", {"momentum": 0.0, "wd": 0.0}),
    ("sgd", {"momentum": 0.0, "wd": 1e-4}),
    ("sgd", {"momentum": 0.9, "wd": 0.0}),
    ("sgd", {"momentum": 0.9, "wd": 1e-4, "clip_gradient": 0.5}),
    ("sgd", {"momentum": 0.0, "wd": 1e-4, "lazy_update": False}),
    ("sgd", {"momentum": 0.9, "wd": 1e-4, "lazy_update": False}),
    ("adam", {"wd": 0.0}),
    ("adam", {"wd": 1e-4, "clip_gradient": 0.5}),
]


def _states(state):
    if state is None:
        return []
    return [s.asnumpy() for s in (state if isinstance(state, tuple)
                                  else (state,))]


@pytest.mark.parametrize("name,params", OPTIMIZERS,
                         ids=["%s-%d" % (n, i)
                              for i, (n, _) in enumerate(OPTIMIZERS)])
def test_lazy_updates_match_jax(name, params):
    rng = np.random.RandomState(17)
    w0 = rng.randn(10, 3).astype(np.float32)
    kw = dict(params, learning_rate=0.1, rescale_grad=0.5)
    jopt, opt = jmx.optimizer.create(name, **kw), \
        mx.optimizer.create(name, **kw)
    lazy = params.get("lazy_update", True)
    with CPU:
        jw, w = jmx.nd.array(w0), mx.nd.array(w0)
        jst, st = jopt.create_state(0, jw), opt.create_state(0, w)
        touched = set()
        for _ in range(4):
            vals = rng.randn(4, 3).astype(np.float32)
            ids = rng.choice([1, 2, 5, 8], 4)          # duplicates
            touched |= set(ids.tolist())
            jopt.update(0, jw, jsp.row_sparse_array((vals, ids),
                                                    shape=(10, 3)), jst)
            opt.update(0, w, sp.row_sparse_array((vals, ids),
                                                 shape=(10, 3)), st)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), **OPT_TOL)
    for a, b in zip(_states(st), _states(jst)):
        np.testing.assert_allclose(a, b, **OPT_TOL)
    if lazy:
        rest = sorted(set(range(10)) - touched)
        np.testing.assert_array_equal(w.asnumpy()[rest], w0[rest])
        for s in _states(st):
            assert not s[rest].any()


def test_sparse_updates_keep_float64():
    opt = mx.optimizer.Adam(learning_rate=0.1)
    with CPU:
        w = mx.nd.array(np.ones((5, 2)), dtype="float64")
        st = opt.create_state(0, w)
        g = sp.row_sparse_array((np.array([[1.0, 1.0], [2.0, 2.0]]),
                                 np.array([2, 2])), shape=(5, 2),
                                dtype="float64")
        opt.update(0, w, g, st)
    assert w.dtype == np.float64
    np.testing.assert_allclose(st[0].asnumpy()[2], 0.1 * 3.0)


# -- Trainer and parameters -----------------------------------------------------

def _embedding(seed=9, sparse_grad=True):
    with CPU:
        emb = gluon.nn.Embedding(20, 3, sparse_grad=sparse_grad)
        emb.initialize(ctx=CPU)
        emb.weight.set_data(mx.nd.array(
            np.random.RandomState(seed).randn(20, 3).astype(np.float32)))
    return emb


def _emb_steps(emb, trainer, steps=4):
    with CPU:
        for _ in range(steps):
            with autograd.record():
                loss = (emb(mx.nd.array(np.array([1, 4, 4, 9],
                                                 np.float32))) ** 2).sum()
            loss.backward()
            trainer.step(1)


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.1}),
])
def test_fused_and_unfused_trainers_agree_bit_for_bit(optimizer, opt_params,
                                                      monkeypatch):
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    weights = []
    for fused in (True, False):
        emb = _embedding()
        assert emb.weight.grad_stype == "row_sparse"
        w0 = emb.weight.data().asnumpy()
        tr = gluon.Trainer(emb.collect_params(), optimizer, dict(opt_params),
                           fused=fused)
        _emb_steps(emb, tr, steps=3)
        with CPU, autograd.record():
            loss = (emb(mx.nd.array(np.array([2, 7, 2], np.float32)))
                    ** 2).sum()
        loss.backward()
        calls = []
        if fused:
            orig = NDArray.asnumpy
            monkeypatch.setattr(NDArray, "asnumpy",
                                lambda self: calls.append(1) or orig(self))
        tr.step(1)
        monkeypatch.undo()
        assert not calls, "the fused step read %d arrays" % len(calls)
        w = emb.weight.data().asnumpy()
        changed = np.where(np.abs(w - w0).sum(axis=1) > 0)[0]
        assert set(changed.tolist()) == {1, 2, 4, 7, 9}
        weights.append(w)
    np.testing.assert_array_equal(weights[0], weights[1])


def test_row_sparse_trainer_matches_jax_and_refuses_a_global_clip():
    jemb = jmx.gluon.nn.Embedding(20, 3, sparse_grad=True)
    jemb.initialize()
    jemb.weight.set_data(jmx.nd.array(
        np.random.RandomState(9).randn(20, 3).astype(np.float32)))
    jtr = jmx.gluon.Trainer(jemb.collect_params(), "adam",
                            {"learning_rate": 0.1}, fused=False)
    for _ in range(4):
        with jmx.autograd.record():
            loss = (jemb(jmx.nd.array(np.array([1, 4, 4, 9], np.float32)))
                    ** 2).sum()
        loss.backward()
        jtr.step(1)
    emb = _embedding()
    _emb_steps(emb, gluon.Trainer(emb.collect_params(), "adam",
                                  {"learning_rate": 0.1}))
    np.testing.assert_allclose(emb.weight.data().asnumpy(),
                               jemb.weight.data().asnumpy(), **OPT_TOL)
    emb = _embedding()
    tr = gluon.Trainer(emb.collect_params(), "sgd", global_norm_clip=1.0)
    with pytest.raises(ValueError, match="dense gradients"):
        _emb_steps(emb, tr, steps=1)


def _jax_mf_module():
    spec = importlib.util.spec_from_file_location(
        "jax_train_matrix_factorization",
        os.path.join(ROOT, "examples", "train_matrix_factorization.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_matrix_factorization_steps_match_jax(optimizer):
    jmf = _jax_mf_module()
    rng = np.random.RandomState(21)
    users, items, ratings = mf.synthetic_ratings(rng, 40, 30, 4, 96)
    jnet = jmf.MFNet(40, 30, 4)
    jnet.initialize(jmx.init.Normal(0.1))
    with CPU:
        net = mf.MFNet(40, 30, 4)
        net.initialize(mx.init.Normal(0.1), ctx=CPU)
    with jmx.autograd.pause():
        jnet(jmx.nd.array(users[:2]), jmx.nd.array(items[:2]))
    params_from_numpy(net, {n: p.data().asnumpy() for n, p in
                            jnet.collect_params().items()},
                      prefix=jnet.prefix)
    kw = {"learning_rate": 0.05}
    jtr = jmx.gluon.Trainer(jnet.collect_params(), optimizer, dict(kw),
                            fused=False)
    tr = gluon.Trainer(net.collect_params(), optimizer, dict(kw))
    jloss_fn, loss_fn = jmx.gluon.loss.L2Loss(), gluon.loss.L2Loss()
    for s in range(3):
        sel = slice(32 * s, 32 * (s + 1))
        with jmx.autograd.record():
            jl = jloss_fn(jnet(jmx.nd.array(users[sel]),
                               jmx.nd.array(items[sel])),
                          jmx.nd.array(ratings[sel])).sum()
        jl.backward()
        jtr.step(32)
        with CPU, autograd.record():
            tl = loss_fn(net(mx.nd.array(users[sel]),
                             mx.nd.array(items[sel])),
                         mx.nd.array(ratings[sel])).sum()
        tl.backward()
        tr.step(32)
        np.testing.assert_allclose(float(tl.asnumpy()),
                                   float(jl.asnumpy()), **MF_TOL)
    jparams, params = jnet.collect_params(), net.collect_params()
    want = {rel: jparams[n].data().asnumpy() for n, rel in
            relative_names(list(jparams.keys()), jnet.prefix).items()}
    rels = relative_names(list(params.keys()), net.prefix)
    assert sorted(rels.values()) == sorted(want)
    for n, rel in rels.items():
        np.testing.assert_allclose(params[n].data().asnumpy(), want[rel],
                                   **MF_TOL)


def test_matrix_factorization_example_runs(capsys):
    vals = mf.main(["--epochs", "2", "--samples", "1024", "--num-users",
                    "80", "--num-items", "60", "--device", "cpu"])
    assert vals[-1] < vals[0]
    assert "val_rmse" in capsys.readouterr().out


def test_parameter_takes_sparse_types():
    p = mx.gluon.Parameter("w", shape=(2, 2), stype="default",
                           grad_stype="row_sparse")
    assert p.grad_stype == "row_sparse"
    with CPU:
        x = mx.nd.ones((2, 2))
        x.attach_grad(stype="row_sparse")        # accepted, ignored
        assert x.grad.stype == "default"
