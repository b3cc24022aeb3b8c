"""NDArray save/load in the reference's binary ``.params`` format.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (reference:
src/ndarray/ndarray.cc:1537-1745, NDArray::Save/Load with
NDARRAY_V2_MAGIC inside the kMXAPINDArrayListMagic list container, and
python/mxnet/ndarray/utils.py:149-222). The layout is the JAX package's
byte for byte: list magic 0x112, per-array V2 magic 0xF993FAC9, the
mshadow type flags, dmlc-serialized names, bfloat16 promoted to float32
on save and 0-d arrays written as shape (1,). A file written by either
package loads in the other, and the same dict gives the same bytes.

Dense arrays only: a ``row_sparse`` or ``csr`` entry raises
NotImplementedError until the sparse NDArrays are ported (ROADMAP
Queue 1 item 11). The round-1 ``.npz`` container of the JAX package is
not read.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import atomic_write
from .ndarray import NDArray, array

__all__ = ["save", "load", "save_dict", "load_dict"]

# src/ndarray/ndarray.cc:1532-1535
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
# src/ndarray/ndarray.cc:1735
_LIST_MAGIC = 0x112

# mshadow type flags (mshadow/base.h kFloat32..kInt64)
_TYPE_FLAG_TO_DTYPE = {
    0: np.float32, 1: np.float64, 2: np.float16,
    3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64,
}
_DTYPE_TO_TYPE_FLAG = {np.dtype(v): k for k, v in _TYPE_FLAG_TO_DTYPE.items()}

_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2


def _write_shape(f, shape):
    """nnvm::TShape::Save — uint32 ndim + int64 dims (tuple.h)."""
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack("<%dq" % len(shape), *shape))


def _read_shape(f, int64=True):
    (ndim,) = struct.unpack("<I", f.read(4))
    if ndim == 0:
        return ()
    fmt = "<%dq" % ndim if int64 else "<%dI" % ndim
    return struct.unpack(fmt, f.read((8 if int64 else 4) * ndim))


def _np_of(arr):
    if isinstance(arr, NDArray):
        return arr.asnumpy()  # bfloat16 widens to float32
    return np.asarray(arr)


def _type_flag(a):
    dt = np.dtype(a.dtype)
    if dt not in _DTYPE_TO_TYPE_FLAG:
        # bfloat16 and types without a flag: promote to float32
        return 0, a.astype(np.float32)
    return _DTYPE_TO_TYPE_FLAG[dt], a


def _save_ndarray(f, arr):
    """NDArray::Save (ndarray.cc:1538-1602), V2 layout, dense."""
    stype = getattr(arr, "stype", "default")
    if stype != "default":
        raise NotImplementedError(
            "saving a %s array: sparse NDArrays are not ported yet "
            "(ROADMAP Queue 1 item 11)" % stype)
    data = _np_of(arr)
    tf, data = _type_flag(data)
    # The reference cannot represent 0-d arrays (TShape ndim 0 means
    # "none", ndarray.cc:1556): scalars are written as shape (1,).
    if data.ndim == 0:
        data = data.reshape(1)
    f.write(struct.pack("<I", _NDARRAY_V2_MAGIC))
    f.write(struct.pack("<i", _STYPE_DEFAULT))
    _write_shape(f, data.shape)
    f.write(struct.pack("<ii", 1, 0))  # Context{cpu, 0}
    f.write(struct.pack("<i", tf))
    f.write(np.ascontiguousarray(data).tobytes())


def _read_raw(f, shape, type_flag):
    dt = np.dtype(_TYPE_FLAG_TO_DTYPE[type_flag])
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    buf = f.read(dt.itemsize * n)
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _array(data, ctx):
    # the file's dtype, float64 included (nd.array narrows float64)
    return array(data, ctx=ctx, dtype=data.dtype)


def _load_ndarray(f, ctx):
    """NDArray::Load, with the legacy V1 / raw-ndim paths
    (ndarray.cc:1604-1733)."""
    (magic,) = struct.unpack("<I", f.read(4))
    if magic != _NDARRAY_V2_MAGIC:
        # LegacyLoad: V1 has an int64 TShape; anything else means `magic`
        # was the ndim of a uint32 legacy shape.
        if magic == _NDARRAY_V1_MAGIC:
            shape = _read_shape(f, int64=True)
        else:
            shape = struct.unpack("<%dI" % magic, f.read(4 * magic)) \
                if magic else ()
        if not shape:
            return array(np.zeros((), np.float32), ctx=ctx)
        f.read(8)  # Context
        (tf,) = struct.unpack("<i", f.read(4))
        return _array(_read_raw(f, shape, tf), ctx)

    (stype,) = struct.unpack("<i", f.read(4))
    if stype != _STYPE_DEFAULT:
        raise NotImplementedError(
            "the file holds a %s array: sparse NDArrays are not ported yet "
            "(ROADMAP Queue 1 item 11)"
            % {_STYPE_ROW_SPARSE: "row_sparse", _STYPE_CSR: "csr"}.get(
                stype, "stype %d" % stype))
    shape = _read_shape(f)
    if not shape:
        return array(np.zeros((), np.float32), ctx=ctx)
    f.read(8)  # Context: always loaded to `ctx` here
    (tf,) = struct.unpack("<i", f.read(4))
    return _array(_read_raw(f, shape, tf), ctx)


def save(fname, data):
    """Save an NDArray, or a list or dict of them (reference mx.nd.save;
    MXNDArraySave, ndarray.cc:1735-1745). The write is atomic."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names = []
        arrays = list(data)
    else:
        raise TypeError("save expects NDArray, list or dict")
    with atomic_write(fname) as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _save_ndarray(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname, ctx=None):
    """Load what :func:`save` or the reference's mx.nd.save wrote: a
    list, or a dict when the file names its arrays (reference mx.nd.load;
    NDArray::Load ndarray.cc:1747-1762). Arrays land on `ctx` (default:
    the current context)."""
    try:
        with open(fname, "rb") as f:
            (header,) = struct.unpack("<Q", f.read(8))
            if header != _LIST_MAGIC:
                raise ValueError("%s: invalid NDArray file format" % fname)
            f.read(8)  # reserved
            (n,) = struct.unpack("<Q", f.read(8))
            arrays = [_load_ndarray(f, ctx) for _ in range(n)]
            (nk,) = struct.unpack("<Q", f.read(8))
            names = []
            for _ in range(nk):
                (ln,) = struct.unpack("<Q", f.read(8))
                names.append(f.read(ln).decode("utf-8"))
    except (struct.error, KeyError, IndexError) as e:
        raise ValueError("%s: invalid NDArray file format (%s)"
                         % (fname, e)) from None
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise ValueError("%s: invalid NDArray file format" % fname)
    return dict(zip(names, arrays))


def save_dict(fname, data):
    save(fname, dict(data))


def load_dict(fname, ctx=None):
    out = load(fname, ctx=ctx)
    if not isinstance(out, dict):
        raise ValueError("%s does not contain a dict" % fname)
    return out
