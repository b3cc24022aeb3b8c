"""The port's RecordIO (``mxnet_tpu_torch.recordio`` and its native core)
against the JAX package's, on records made from a seed with numpy.

Files are byte-identical across the packages: a ``.rec``/``.idx`` pair
written by either reads back in the other with the same records and
keys, and both write the same bytes for the same records. The native
index and reads equal the pure-python ones. Exact equality throughout:
the format is bytes.
"""
import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu.recordio as jrio

import mxnet_tpu_torch.recordio as rio
from mxnet_tpu_torch import recordio_native
from mxnet_tpu_torch.data import reader as port_reader

PACKAGES = {"jax": jrio, "port": rio}


def _records(seed=0, n=23):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        payload = rng.bytes(int(rng.randint(0, 300)))
        if i % 3 == 0:
            label = rng.rand(int(rng.randint(1, 5))).astype(np.float32)
        else:
            label = float(rng.randint(0, 1000))
        out.append(rio.pack(rio.IRHeader(0, label, i, i * 7), payload))
    return out


def _write(pkg, rec, idx, records):
    w = pkg.MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(records):
        w.write_idx(i, r)
    w.close()


def _read_all(pkg, rec, idx):
    r = pkg.MXIndexedRecordIO(idx, rec, "r")
    try:
        return list(r.keys), [r.read_idx(k) for k in r.keys]
    finally:
        r.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_files_read_back_across_packages(tmp_path, writer, reader):
    records = _records()
    rec, idx = str(tmp_path / "a.rec"), str(tmp_path / "a.idx")
    _write(PACKAGES[writer], rec, idx, records)
    keys, got = _read_all(PACKAGES[reader], rec, idx)
    assert keys == list(range(len(records)))
    assert got == records
    seq = PACKAGES[reader].MXRecordIO(rec, "r")
    try:
        assert [seq.read() for _ in records] == records
        assert seq.read() is None
    finally:
        seq.close()


def test_both_packages_write_the_same_bytes(tmp_path):
    records = _records(seed=1)
    files = {}
    for name, pkg in PACKAGES.items():
        rec, idx = str(tmp_path / (name + ".rec")), str(tmp_path / (name + ".idx"))
        _write(pkg, rec, idx, records)
        with open(rec, "rb") as f, open(idx, "rb") as g:
            files[name] = (f.read(), g.read())
    assert files["jax"] == files["port"]


@pytest.mark.parametrize("label", [3.0, [1.5, -2.0, 7.25]])
def test_pack_unpack_equal_across_packages(label):
    payload = np.random.RandomState(2).bytes(57)
    header = rio.IRHeader(0, label, 11, 4)
    packed = rio.pack(header, payload)
    assert packed == jrio.pack(jrio.IRHeader(0, label, 11, 4), payload)
    h_port, s_port = rio.unpack(packed)
    h_jax, s_jax = jrio.unpack(packed)
    assert s_port == s_jax == payload
    assert h_port.flag == h_jax.flag and h_port.id == h_jax.id
    np.testing.assert_array_equal(np.asarray(h_port.label),
                                  np.asarray(h_jax.label))


def test_png_pack_img_reads_back_in_the_jax_package():
    img = np.random.RandomState(3).randint(0, 256, (9, 13, 3), np.uint8)
    packed = rio.pack_img(rio.IRHeader(0, 5.0, 1, 0), img, img_fmt=".png")
    header, got = jrio.unpack_img(packed)
    np.testing.assert_array_equal(got, img)
    assert header.label == 5.0
    _, back = rio.unpack_img(packed)
    np.testing.assert_array_equal(back, img)


def _chunked_file(path, records):
    """A .rec whose odd records span three chunks (cflag 1, 2, 3)."""
    with open(path, "wb") as f:
        for i, data in enumerate(records):
            if i % 2 and len(data) >= 3:
                cut = [0, len(data) // 3, 2 * len(data) // 3, len(data)]
                parts = [(1, data[cut[0]:cut[1]]), (2, data[cut[1]:cut[2]]),
                         (3, data[cut[2]:])]
            else:
                parts = [(0, data)]
            for cflag, part in parts:
                f.write(struct.pack("<II", 0xced7230a,
                                    (cflag << 29) | len(part)))
                f.write(part + b"\x00" * ((4 - len(part) % 4) % 4))


@pytest.mark.parametrize("chunked", [False, True])
def test_native_index_and_reads_equal_python(tmp_path, chunked):
    assert recordio_native.available()
    records = _records(seed=4)
    rec = str(tmp_path / "c.rec")
    if chunked:
        _chunked_file(rec, records)
    else:
        _write(rio, rec, str(tmp_path / "c.idx"), records)
    offsets = recordio_native.native_index(rec)
    assert offsets == port_reader._python_index(rec)
    from mxnet_tpu.data import reader as jax_reader

    assert offsets == jax_reader._python_index(rec)
    reads0 = recordio_native.READS
    with open(rec, "rb") as f:
        for off, want in zip(offsets, records):
            data, end = recordio_native.native_read_at(rec, off)
            assert data == want
            f.seek(off)
            assert rio.read_logical_record(f, rec) == want
            assert f.tell() == end
    assert recordio_native.READS - reads0 == len(records)


def test_native_library_builds_into_the_ports_build_dir():
    path = recordio_native.library_path()
    assert recordio_native.available()
    assert os.path.dirname(path).endswith(os.path.join("mxnet_tpu_torch",
                                                       "_build"))
    assert os.path.exists(path)
    assert not any(n.startswith(os.path.basename(path) + ".build.")
                   for n in os.listdir(os.path.dirname(path)))


def test_python_path_when_native_reads_are_off(tmp_path, monkeypatch):
    records = _records(seed=5, n=6)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    _write(rio, rec, idx, records)
    monkeypatch.setenv("MXNET_USE_NATIVE_RECORDIO", "0")
    reads0 = recordio_native.READS
    assert _read_all(rio, rec, idx)[1] == records
    assert recordio_native.READS == reads0


def test_handle_pickles_and_reopens(tmp_path):
    records = _records(seed=6, n=5)
    rec, idx = str(tmp_path / "e.rec"), str(tmp_path / "e.idx")
    _write(rio, rec, idx, records)
    r = rio.MXIndexedRecordIO(idx, rec, "r")
    clone = pickle.loads(pickle.dumps(r))
    try:
        assert clone.read_idx(3) == records[3]
        assert r.read_idx(4) == records[4]
    finally:
        clone.close()
        r.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bad_magic_raises(tmp_path, pkg):
    rec = str(tmp_path / "bad.rec")
    with open(rec, "wb") as f:
        f.write(struct.pack("<II", 0xdeadbeef, 4) + b"abcd")
    r = PACKAGES[pkg].MXRecordIO(rec, "r")
    try:
        with pytest.raises(IOError, match="magic"):
            r.read()
    finally:
        r.close()
    with pytest.raises(IOError):
        recordio_native.native_index(rec)
