"""Sequence and linear-algebra operators.

Counterpart of ``mxnet_tpu/ops/sequence.py``. The sequence half (:33-78;
reference src/operator/sequence_mask.cc, sequence_last.cc,
sequence_reverse.cc): data is (T, N, ...) with ``axis=0`` or (N, T,
...) with ``axis=1``; lengths, when used, are one per sequence and may
arrive as floats: they are truncated to integers, as the JAX op casts
them.

The linalg half (:79-198; reference src/operator/tensor/la_op.cc, the
``linalg_*`` ops and ``khatri_rao``) runs on ``torch.linalg`` where the
JAX package runs ``jnp.linalg`` and ``jax.scipy.linalg`` (XLA, no
Pallas kernel), batched over the leading axes, and its gradients come
from autograd. Not unique, as in LAPACK: the signs of ``gelqf``'s rows
of Q (and L's columns) and of ``syevd``'s eigenvectors (rows of U);
cuSOLVER on a card may pick other signs than LAPACK on the host.
"""
from __future__ import annotations

import torch

from .registry import register


def _lengths(sequence_length, t):
    """Integer lengths, at most `t`: a longer one would index past the
    sequence (the JAX op's gathers clamp; a CUDA gather would assert)."""
    return torch.clamp(sequence_length.to(torch.int64), max=t)


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """`value` at every step at or past its sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    t = data.shape[axis]
    mask = torch.arange(t, device=data.device)[:, None] \
        < _lengths(sequence_length, t)[None, :]
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    last = _lengths(sequence_length, data.shape[axis]) - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    if axis == 0:
        return data[last, batch]
    return data[batch, last]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Each sequence's valid prefix reversed in time, its padding left in
    place. Time is axis 0, as in the reference, whose op supports no
    other: the port raises on another `axis` (the JAX op ignores it)."""
    if axis != 0:
        raise ValueError("SequenceReverse supports axis=0 only, got %r"
                         % (axis,))
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    t, b = data.shape[0], data.shape[1]
    lens = _lengths(sequence_length, t)[None, :]
    tt = torch.arange(t, device=data.device)[:, None]
    src = torch.where(tt < lens, lens - 1 - tt, tt)
    src = src.reshape((t, b) + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, src)


# ---------------------------------------------------------------------------
# linalg (reference la_op.cc)
# ---------------------------------------------------------------------------

def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    """alpha op(A) op(B) + beta C."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    """alpha op(A) op(B)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _linalg_potrf(A, lower=True):
    """The Cholesky factor of SPD A: L (lower) or L^T."""
    L = torch.linalg.cholesky(A)
    return L if lower else _t(L)


@register("_linalg_potri", aliases=("linalg_potri",))
def _linalg_potri(A, lower=True):
    """inv(L L^T) from the Cholesky FACTOR A = L (lower) or L^T: the
    input is the factor, not the matrix."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    inv = torch.linalg.solve_triangular(A, eye, upper=not lower)
    return torch.matmul(_t(inv), inv) if lower else torch.matmul(inv, _t(inv))


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """X with op(A) X = alpha B (X op(A) = alpha B with `rightside`), A
    triangular (only its `lower` or upper triangle is read)."""
    a = _t(A) if transpose else A
    return torch.linalg.solve_triangular(a, B * alpha,
                                         upper=lower == transpose,
                                         left=not rightside)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """alpha op(tri(A)) B (B op(tri(A)) with `rightside`), tri(A) the
    `lower` or upper triangle of A."""
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha A A^T (alpha A^T A with `transpose`)."""
    if transpose:
        return alpha * torch.matmul(_t(A), A)
    return alpha * torch.matmul(A, _t(A))


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _linalg_sumlogdiag(A):
    """sum(log(diag(A))) per matrix."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_gelqf", aliases=("linalg_gelqf",))
def _linalg_gelqf(A):
    """(L, Q), A = L Q with Q's rows orthonormal: the LQ factorization,
    through the QR of A^T."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_syevd", aliases=("linalg_syevd",))
def _linalg_syevd(A):
    """(U, w): the eigenvectors of symmetric A as the ROWS of U and the
    eigenvalues w ascending, A = U^T diag(w) U. A is symmetrized first,
    as ``jnp.linalg.eigh`` does, so its gradient is symmetric. A float32
    A on a card is factorized in float64 and the factors rounded:
    torch's float32 route there (cuSOLVER; an H100 at batch 32 x 256 x
    256) leaves a backward error of 6 n eps, nearly half of what factors
    rounded to TF32 leave (chip_smoke.py phase 17)."""
    s = (A + _t(A)) / 2
    if s.is_cuda and s.dtype == torch.float32:
        w, v = torch.linalg.eigh(s.double())
        return _t(v).float(), w.float()
    w, v = torch.linalg.eigh(s)
    return _t(v), w


@register("_linalg_inverse", aliases=("linalg_inverse",))
def _linalg_inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_det", aliases=("linalg_det",))
def _linalg_det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", aliases=("linalg_slogdet",))
def _linalg_slogdet(A):
    """(sign, log |det A|)."""
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("khatri_rao")
def _khatri_rao(*args):
    """Column-wise Kronecker product of (m_i, k) matrices: (prod m_i, k)."""
    out = args[0]
    for b in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, b).reshape(
            out.shape[0] * b.shape[0], *out.shape[1:])
    return out
