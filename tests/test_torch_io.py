"""``mxnet_tpu_torch.io`` iterators against the JAX package's
``mxnet_tpu.io``, on the same numpy data made from a seed: every batch,
``pad`` included, equal exactly (integer and float32 data alike — both
packages slice and concatenate the same numpy arrays). Shuffles are
compared with the JAX global ``numpy.random`` and the port's explicit
generator seeded alike. Also the PrefetchingIter's error relay and
bounded close, and its placement on the card (``cuda``-marked).
"""
import gzip
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

CPU = mx.cpu()


def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        if n is not None and i >= n:
            break
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _data(seed=0, n=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 2).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_equals_jax(handle, shuffle):
    x, y = _data()
    np.random.seed(3)
    jit = jmx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                             last_batch_handle=handle)
    it = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                           last_batch_handle=handle, ctx=CPU,
                           rng=np.random.RandomState(3))
    assert [tuple(d) for d in it.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for _ in range(2):          # two epochs: roll_over carries over
        _assert_same(_batches(it), _batches(jit))
        it.reset()
        jit.reset()


def test_ndarray_iter_dict_inputs_and_context():
    x, y = _data(seed=1, n=6)
    it = mx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, batch_size=3,
                           ctx=CPU)
    jit = jmx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, batch_size=3)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    b = it.next()
    assert b.data[0].context == CPU
    it.reset()
    _assert_same(_batches(it), _batches(jit))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_equals_jax(tmp_path, round_batch):
    x, y = _data(seed=2, n=7)
    data_csv, label_csv = str(tmp_path / "x.csv"), str(tmp_path / "y.csv")
    np.savetxt(data_csv, x.reshape(7, -1), delimiter=",")
    np.savetxt(label_csv, y.reshape(7, 1), delimiter=",")
    kw = dict(data_csv=data_csv, data_shape=(3, 2), label_csv=label_csv,
              batch_size=3, round_batch=round_batch)
    it = mx.io.CSVIter(ctx=CPU, **kw)
    jit = jmx.io.CSVIter(**kw)
    assert [tuple(d) for d in it.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(2):
        _assert_same(_batches(it), _batches(jit))
        it.reset()
        jit.reset()


def _write_idx(path, arr, gz=False):
    code = {np.uint8: 8, np.int32: 12}[arr.dtype.type]
    body = struct.pack(">HBB", 0, code, arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape) + \
        arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open(path + ".gz", "wb") if gz else open(path, "wb")) as f:
        f.write(body)


@pytest.mark.parametrize("flat,shuffle,parts", [
    (False, True, 1), (True, False, 1), (False, False, 3)])
def test_mnist_iter_equals_jax(tmp_path, flat, shuffle, parts):
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (11, 5, 4)).astype(np.uint8)
    labels = rng.randint(0, 10, 11).astype(np.uint8)
    img, lab = str(tmp_path / "img-idx3-ubyte"), str(tmp_path / "lab-idx1-ubyte")
    _write_idx(img, images, gz=True)
    _write_idx(lab, labels)
    for index in range(parts):
        kw = dict(image=img, label=lab, batch_size=2, shuffle=shuffle,
                  flat=flat, seed=7, num_parts=parts, part_index=index)
        _assert_same(_batches(mx.io.MNISTIter(ctx=CPU, **kw)),
                     _batches(jmx.io.MNISTIter(**kw)))


def test_mnist_iter_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="not found"):
        mx.io.MNISTIter(image=str(tmp_path / "nope"), label=str(tmp_path / "x"))


def test_resize_iter_equals_jax():
    x, y = _data(seed=5, n=9)
    it = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=4, ctx=CPU), 5)
    jit = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, batch_size=4), 5)
    got, want = _batches(it), _batches(jit)
    assert len(got) == 5
    _assert_same(got, want)


def test_prefetching_iter_equals_jax_with_renames():
    x, y = _data(seed=6, n=8)
    x2 = x + 1

    def make(io, **kw):
        return io.PrefetchingIter(
            [io.NDArrayIter(x, y, batch_size=3, **kw),
             io.NDArrayIter({"data": x2}, {"softmax_label": y}, batch_size=3,
                            **kw)],
            rename_data=[{"data": "d0"}, {"data": "d1"}],
            rename_label=[{"softmax_label": "l0"},
                          {"softmax_label": "l1"}])

    it, jit = make(mx.io, ctx=CPU), make(jmx.io)
    try:
        assert [d.name for d in it.provide_data] == ["d0", "d1"]
        for _ in range(2):
            _assert_same(_batches(it), _batches(jit))
            it.reset()
            jit.reset()
    finally:
        it.close()
        jit.close()


class _Failing(mx.io.DataIter):
    """Yields `ok` batches, then raises once, then yields again."""

    def __init__(self, ok=2):
        super().__init__(2)
        self.n = 0
        self.ok = ok
        self.provide_data = [mx.io.DataDesc("data", (2, 3))]
        self.provide_label = [mx.io.DataDesc("softmax_label", (2,))]

    def next(self):
        self.n += 1
        if self.n == self.ok + 1:
            raise ValueError("decode failed at batch %d" % self.n)
        if self.n > self.ok + 3:
            raise StopIteration
        return mx.io.DataBatch([mx.nd.ones((2, 3), ctx=CPU) * self.n],
                               [mx.nd.zeros((2,), ctx=CPU)], pad=0)


def test_prefetching_iter_relays_errors_and_closes_bounded():
    it = mx.io.PrefetchingIter(_Failing())
    got = [it.next().data[0].asnumpy()[0, 0] for _ in range(2)]
    assert got == [1.0, 2.0]
    with pytest.raises(ValueError, match="decode failed"):
        it.next()
    assert it.next().data[0].asnumpy()[0, 0] == 4.0
    t0 = time.monotonic()
    it.close()
    it.close()
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in it.prefetch_threads)
    with pytest.raises(StopIteration):
        it.next()


class _Staged(mx.io.PrefetchingIter):
    """The staged path on the host: a stand-in stager hands back the
    batch's tensors, as PinnedStager hands back their copies on the
    card, so the bookkeeping around it runs here."""

    placed = 0

    def _make_stagers(self, ctx):
        def stager(parts):
            _Staged.placed += 1
            return tuple([d.data_.clone() for d in part] for part in parts)

        return [stager] * self.n_iter


def test_prefetching_iter_delivers_what_its_stager_placed():
    x, y = _data(seed=7, n=10)
    it = _Staged(mx.io.NDArrayIter(x, y, batch_size=4, ctx=CPU), ctx=CPU)
    try:
        got = _batches(it)
    finally:
        it.close()
    _assert_same(got, _batches(mx.io.NDArrayIter(x, y, batch_size=4,
                                                 ctx=CPU)))
    assert _Staged.placed >= 3 and got[-1][2] == 2
    assert all(isinstance(d, np.ndarray) for d in got[0][0])


def test_libsvm_iter_names_its_roadmap_item(tmp_path):
    # tests/test_io.py's LibSVM case, bit for bit the JAX iterator's
    # batch (the name is kept from when it raised).
    path = str(tmp_path / "data.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0\n")
    b = next(mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                              batch_size=3, ctx=CPU))
    jb = next(jmx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                batch_size=3))
    assert b.data[0].stype == "csr" and b.data[0].context == CPU
    np.testing.assert_array_equal(b.data[0].asnumpy()[0], [1.5, 0, 0, 2.0])
    np.testing.assert_array_equal(b.data[0].asnumpy(),
                                  jb.data[0].asnumpy())
    np.testing.assert_array_equal(b.label[0].asnumpy(),
                                  jb.label[0].asnumpy())


def test_data_desc_and_batch_equal_jax():
    d = mx.io.DataDesc("data", (4, 3), np.int32, "NC")
    jd = jmx.io.DataDesc("data", (4, 3), np.int32, "NC")
    assert repr(d) == repr(jd)
    assert mx.io.DataDesc.get_batch_axis("TNC") == \
        jmx.io.DataDesc.get_batch_axis("TNC") == 1
    assert [tuple(x) for x in mx.io.DataDesc.get_list([("a", (1, 2))],
                                                       [("a", np.int8)])] \
        == [("a", (1, 2))]
    b = mx.io.DataBatch([mx.nd.ones((2, 2), ctx=CPU)])
    assert str(b) == "DataBatch: data shapes: [(2, 2)] label shapes: None"


def test_default_context_iterator_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        mx.io.NDArrayIter(x, y, batch_size=2).next()
    with pytest.raises(RuntimeError, match="CUDA"):
        mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=2, ctx=CPU),
                              ctx=mx.gpu(0))


@pytest.mark.cuda
def test_prefetching_iter_places_on_the_card_through_pinned_staging():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = _data(seed=8, n=64)
    gpu = mx.gpu(0)
    it = mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=8,
                                                 ctx=CPU), ctx=gpu)
    try:
        got = []
        for b in it:
            assert b.data[0].context == gpu
            # Work on the consumer's stream right after delivery reads
            # the copied bytes, not the buffer being filled.
            got.append((b.data[0].data_ * 1).cpu().numpy())
        np.testing.assert_array_equal(np.concatenate(got), x)
    finally:
        it.close()
