"""Sparse NDArray storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
include/mxnet/ndarray.h:61-65 kRowSparseStorage/kCSRStorage,
python/mxnet/ndarray/sparse.py, src/operator/tensor/cast_storage-inl.h).

The layout is the JAX package's: a sparse array is an NDArray whose
``_data`` holds the stored values, with ``_indices`` (and, for CSR,
``_indptr``) int64 NDArrays beside it and ``shape`` the full logical
shape (``_full_shape``). Values and index arrays live on the array's
context. Compute runs on that device with torch's indexing ops: a
gather (``index_select``) and a segment sum (``index_add_``) for
``dot(csr, dense)``, a search over ``indptr`` for the row of each CSR
nonzero. Other sparse combinations densify and take the dense ``dot``,
the reference's storage fallback.

Differences from the JAX package:

- ``dense_to_rsp_device`` returns exactly the nonzero rows. The JAX
  package pads the row list to a power of two with the out-of-range id
  ``num_rows`` so that XLA reuses one executable per count, relying on
  XLA to clamp the gather and drop the scatter; torch does neither (an
  out-of-range id raises on the host and is a device-side assert on a
  card), and eager torch compiles nothing, so the port does not pad.
- 64-bit values stay 64-bit (``_aggregate_rows_np`` narrows to float32
  there).
- Results are placed on the input's context, and a fresh array on the
  current one; the JAX package rebuilds several through numpy with no
  context.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from .ndarray import NDArray, array, zeros as _dense_zeros, _invoke

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "dense_to_rsp_device", "cast_storage", "zeros", "retain", "dot"]


def _on(arr, ctx, dtype=None):
    """`arr` (an NDArray or array-like) as an NDArray on `ctx`."""
    if isinstance(arr, NDArray):
        if arr.context != ctx:
            arr = arr.copyto(ctx)
        return arr if dtype is None else arr.astype(dtype, copy=False)
    return array(arr, ctx=ctx, dtype=dtype)


def _index(arr, ctx):
    return _on(arr if isinstance(arr, NDArray) else np.asarray(arr), ctx,
               "int64")


class BaseSparseNDArray(NDArray):
    """Common base (reference: python/mxnet/ndarray/sparse.py)."""

    _aux_names = ()

    def _aux(self):
        return [getattr(self, n) for n in self._aux_names]

    def asnumpy(self):
        return self.todense().asnumpy()

    def dot(self, other):
        return dot(self, other)

    def wait_to_read(self):
        """Wait for the values and every index array."""
        super().wait_to_read()
        for a in self._aux():
            a.wait_to_read()

    wait_to_write = wait_to_read

    @property
    def shape(self):
        return self._full_shape

    @property
    def data(self):
        return NDArray(self._data, ctx=self._ctx)

    @property
    def indices(self):
        return self._indices

    def copyto(self, other):
        from ..context import Context

        if isinstance(other, Context):
            return self.as_in_context(other)
        return self.todense().copyto(other)

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self._full_shape)),
                                  self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse: ``values[i]`` is row ``indices[i]`` (reference:
    ndarray.h kRowSparseStorage, the gradient format of embeddings)."""

    _aux_names = ("_indices",)

    def __init__(self, data, indices, shape, ctx=None):
        values = data if isinstance(data, NDArray) else \
            array(data, ctx=ctx, dtype=getattr(data, "dtype", None))
        ctx = ctx if ctx is not None else values.context
        super().__init__(_on(values, ctx)._data, ctx=ctx)
        self._indices = _index(indices, ctx)
        self._full_shape = tuple(shape)

    @property
    def stype(self):
        return "row_sparse"

    def todense(self):
        with torch.no_grad():
            out = torch.zeros(self._full_shape, dtype=self._data.dtype,
                              device=self._data.device)
            out[self._indices._data] = self._data
        return NDArray(out, ctx=self._ctx)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cast row_sparse -> %s not supported" % stype)

    def as_in_context(self, ctx):
        """A context move that keeps the storage type (the reference's
        row-sparse CopyFromTo)."""
        if ctx == self._ctx:
            return self
        return RowSparseNDArray(self.data.copyto(ctx),
                                self._indices.copyto(ctx),
                                self._full_shape, ctx=ctx)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self._indices.copy(),
                                self._full_shape, ctx=self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (reference: kCSRStorage; the batches
    of LibSVMIter and the sparse linear models)."""

    _aux_names = ("_indptr", "_indices")

    def __init__(self, data, indptr, indices, shape, ctx=None):
        values = data if isinstance(data, NDArray) else \
            array(data, ctx=ctx, dtype=getattr(data, "dtype", None))
        ctx = ctx if ctx is not None else values.context
        super().__init__(_on(values, ctx)._data, ctx=ctx)
        self._indptr = _index(indptr, ctx)
        self._indices = _index(indices, ctx)
        self._full_shape = tuple(shape)

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return self._indptr

    def _rows(self):
        """The row of each stored value: a search over ``indptr``."""
        indptr = self._indptr._data
        nnz = self._indices._data.shape[0]
        k = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
        return torch.searchsorted(indptr, k, right=True) - 1

    def todense(self):
        with torch.no_grad():
            out = torch.zeros(self._full_shape, dtype=self._data.dtype,
                              device=self._data.device)
            out[self._rows(), self._indices._data] = self._data
        return NDArray(out, ctx=self._ctx)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cast csr -> %s not supported" % stype)

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return CSRNDArray(self.data.copyto(ctx), self._indptr.copyto(ctx),
                          self._indices.copyto(ctx), self._full_shape,
                          ctx=ctx)

    def copy(self):
        return CSRNDArray(self.data.copy(), self._indptr.copy(),
                          self._indices.copy(), self._full_shape,
                          ctx=self._ctx)


def _ctx_or_current(ctx):
    return ctx if ctx is not None else current_context()


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or from a dense
    array-like, whose nonzero rows are kept (reference:
    sparse.py:row_sparse_array)."""
    ctx = _ctx_or_current(ctx)
    dtype = dtype or np.float32
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(
            array(np.asarray(data, dtype=dtype), ctx=ctx, dtype=dtype),
            np.asarray(indices), shape, ctx=ctx)
    dense = np.asarray(arg1, dtype=dtype)
    nz_rows = np.where(np.any(dense != 0,
                              axis=tuple(range(1, dense.ndim))))[0]
    return RowSparseNDArray(array(dense[nz_rows], ctx=ctx, dtype=dtype),
                            nz_rows, dense.shape, ctx=ctx)


def dense_to_rsp_device(arr):
    """A dense NDArray as a RowSparseNDArray of its nonzero rows, found on
    the array's device: the Trainer's row-sparse step uses it in place of
    ``row_sparse_array(grad.asnumpy())``, so the gradient never crosses to
    the host. The one host read is the count of nonzero rows (the size of
    ``torch.nonzero``'s result). The rows are unique and ascending, and
    the result is flagged ``_rows_ready`` so the optimizer skips their
    aggregation."""
    data = arr._data.detach()
    with torch.no_grad():
        mask = data != 0
        if data.ndim > 1:
            mask = mask.reshape(data.shape[0], -1).any(dim=1)
        idx = torch.nonzero(mask).reshape(-1)
        vals = data.index_select(0, idx)
    ctx = arr.context
    out = RowSparseNDArray(NDArray(vals, ctx=ctx), NDArray(idx, ctx=ctx),
                           tuple(arr.shape), ctx=ctx)
    out._rows_ready = True
    return out


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense 2-D
    array-like, in one vectorized nonzero scan (reference:
    sparse.py:csr_matrix)."""
    ctx = _ctx_or_current(ctx)
    dtype = dtype or np.float32
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(
            array(np.asarray(data, dtype=dtype), ctx=ctx, dtype=dtype),
            np.asarray(indptr), np.asarray(indices), shape, ctx=ctx)
    dense = np.asarray(arg1, dtype=dtype)
    m, n = dense.shape
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRNDArray(array(dense[rows, cols], ctx=ctx, dtype=dtype), indptr,
                      cols.astype(np.int64), (m, n), ctx=ctx)


def cast_storage(arr, stype):
    """Reference: src/operator/tensor/cast_storage-inl.h. The result lies
    on `arr`'s context and keeps its dtype."""
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    make = {"row_sparse": (RowSparseNDArray, row_sparse_array),
            "csr": (CSRNDArray, csr_matrix)}.get(stype)
    if make is None:
        raise ValueError("unknown stype %s" % stype)
    if isinstance(arr, make[0]):
        return arr
    host = arr.asnumpy()
    return make[1](host, ctx=arr.context, dtype=host.dtype)


def zeros(stype, shape, ctx=None, dtype=None):
    ctx = _ctx_or_current(ctx)
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    dtype = dtype or np.float32
    if stype == "row_sparse":
        return RowSparseNDArray(
            array(np.zeros((0,) + tuple(shape[1:]), dtype), ctx=ctx,
                  dtype=dtype),
            np.zeros((0,), np.int64), shape, ctx=ctx)
    if stype == "csr":
        return CSRNDArray(
            array(np.zeros((0,), dtype), ctx=ctx, dtype=dtype),
            np.zeros((shape[0] + 1,), np.int64), np.zeros((0,), np.int64),
            shape, ctx=ctx)
    raise ValueError(stype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference src/operator/tensor/dot-inl.h, the
    dot(csr, dense) and dot(csr.T, dense) kernels).

    ``dot(csr, dense)`` gathers the right-hand rows of each stored value
    and sums them into the output rows (``index_add_``, a segment sum
    over the nnz stream); ``transpose_a`` sums into the output row of
    each value's column instead. A vector right-hand side gives a
    vector. Other sparse combinations densify and take the dense dot.
    Not recorded by autograd, as in the JAX package.
    """
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, BaseSparseNDArray):
        assert not transpose_b, "dot(csr, dense, transpose_b) unsupported"
        m, n = lhs.shape
        cols = lhs._indices._data
        vals = lhs._data
        r = rhs._data.detach()
        vec = r.ndim == 1
        if vec:
            r = r[:, None]
        with torch.no_grad():
            rows = lhs._rows()
            src, dst, out_rows = (cols, rows, m) if not transpose_a \
                else (rows, cols, n)
            contrib = vals[:, None] * r.index_select(0, src)
            out = torch.zeros((out_rows, r.shape[1]), dtype=contrib.dtype,
                              device=contrib.device)
            out.index_add_(0, dst, contrib)
        if vec:
            out = out[:, 0]
        return NDArray(out, ctx=lhs.context)
    if isinstance(lhs, BaseSparseNDArray) or isinstance(rhs,
                                                        BaseSparseNDArray):
        # The storage fallback (reference kFComputeFallback).
        lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return _invoke("dot", [lhs, rhs], transpose_a=transpose_a,
                   transpose_b=transpose_b)


def _gather_rows(rsp, row_ids):
    """Rows of a RowSparseNDArray by id (numpy ids, or a tensor of them):
    absent rows are zeros, with no densification (reference kvstore
    PullRowSparse). Handles unsorted stored indices and empty stores."""
    vals = rsp._data
    req = torch.as_tensor(np.asarray(row_ids) if not torch.is_tensor(row_ids)
                          else row_ids, dtype=torch.int64,
                          device=vals.device)
    if rsp.indices.shape[0] == 0:
        return NDArray(torch.zeros((req.shape[0],) + tuple(rsp.shape[1:]),
                                   dtype=vals.dtype, device=vals.device),
                       ctx=rsp.context)
    with torch.no_grad():
        stored = rsp._indices._data
        order = torch.argsort(stored)
        sorted_idx = stored[order]
        pos = torch.searchsorted(sorted_idx, req).clamp(
            0, sorted_idx.shape[0] - 1)
        hit = (sorted_idx[pos] == req).to(vals.dtype)
        rows = vals[order[pos]] * hit.reshape((-1,) + (1,) * (vals.ndim - 1))
    return NDArray(rows, ctx=rsp.context)


def _aggregate_rows(values, indices):
    """Sum the rows of duplicate ids: ``(unique ids ascending, summed
    rows)``, tensors on the inputs' device, each sum in the order the
    ids occur (``index_add_``)."""
    with torch.no_grad():
        uniq, inv = torch.unique(indices, sorted=True, return_inverse=True)
        out = torch.zeros((uniq.shape[0],) + tuple(values.shape[1:]),
                          dtype=values.dtype, device=values.device)
        out.index_add_(0, inv, values)
    return uniq, out


def _aggregate_rows_np(values_np, indices_np, row_shape):
    """The host form of :func:`_aggregate_rows`: sorted int64 ids and the
    summed rows, float64 kept, any other type as float32."""
    values = np.asarray(values_np)
    dt = np.float64 if values.dtype == np.float64 else np.float32
    uniq, out = _aggregate_rows(
        torch.from_numpy(np.ascontiguousarray(
            values.astype(dt, copy=False).reshape(
                (-1,) + tuple(row_shape)))),
        torch.from_numpy(np.asarray(indices_np, np.int64)))
    return uniq.numpy(), out.numpy()


def _aggregate_rsp(values, indices, shape, ctx):
    """Rows `values` (a tensor) of ids `indices` (an int64 tensor), both
    on `ctx`'s device, as one RowSparseNDArray with its duplicate ids
    summed and its ids ascending (the merge of the reference's
    row-sparse reduce, comm.h)."""
    uniq, out = _aggregate_rows(values, indices)
    return RowSparseNDArray(NDArray(out, ctx=ctx), NDArray(uniq, ctx=ctx),
                            shape, ctx=ctx)


def retain(arr, indices):
    """sparse_retain (reference: src/operator/tensor/sparse_retain-inl.h):
    the stored rows whose ids are in `indices`."""
    if not isinstance(arr, RowSparseNDArray):
        raise TypeError("retain expects RowSparseNDArray")
    keep = np.asarray(indices.asnumpy() if isinstance(indices, NDArray)
                      else indices, np.int64)
    old_idx = arr.indices.asnumpy()
    mask = np.isin(old_idx, keep)
    vals = arr.data.asnumpy()[mask]
    return RowSparseNDArray(array(vals, ctx=arr.context, dtype=vals.dtype),
                            old_idx[mask], arr.shape, ctx=arr.context)
