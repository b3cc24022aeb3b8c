"""`mx.nd.linalg` (reference: python/mxnet/ndarray/linalg.py over la_op.cc).

Counterpart of ``mxnet_tpu/ndarray/linalg.py``: each function dispatches
the registered ``_linalg_*`` operator (``ops/sequence.py``).
"""
from __future__ import annotations

from .ndarray import _invoke

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
           "sumlogdiag", "gelqf", "syevd", "inverse", "det", "slogdet"]


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0, **kw):
    return _invoke("_linalg_gemm", [A, B, C], transpose_a=transpose_a,
                   transpose_b=transpose_b, alpha=alpha, beta=beta)


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
    return _invoke("_linalg_gemm2", [A, B], transpose_a=transpose_a,
                   transpose_b=transpose_b, alpha=alpha)


def potrf(A, lower=True, **kw):
    return _invoke("_linalg_potrf", [A], lower=lower)


def potri(A, lower=True, **kw):
    return _invoke("_linalg_potri", [A], lower=lower)


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0, **kw):
    return _invoke("_linalg_trsm", [A, B], transpose=transpose,
                   rightside=rightside, lower=lower, alpha=alpha)


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0, **kw):
    return _invoke("_linalg_trmm", [A, B], transpose=transpose,
                   rightside=rightside, lower=lower, alpha=alpha)


def syrk(A, transpose=False, alpha=1.0, **kw):
    return _invoke("_linalg_syrk", [A], transpose=transpose, alpha=alpha)


def sumlogdiag(A, **kw):
    return _invoke("_linalg_sumlogdiag", [A])


def gelqf(A, **kw):
    return _invoke("_linalg_gelqf", [A])


def syevd(A, **kw):
    return _invoke("_linalg_syevd", [A])


def inverse(A, **kw):
    return _invoke("_linalg_inverse", [A])


def det(A, **kw):
    return _invoke("_linalg_det", [A])


def slogdet(A, **kw):
    return _invoke("_linalg_slogdet", [A])
