"""The linalg half of ``ops/sequence.py`` (27 names: 13 operators as
``_linalg_*`` and ``linalg_*``, and ``khatri_rao``) and ``nd.linalg`` in
the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through each package's
imperative dispatch; forward outputs are compared, and the gradients of
every float input for random head gradients on the outputs named in a
case (``slogdet``'s sign has none). Matrices that must be SPD are
B B^T + n I (well conditioned); triangular inputs are the Cholesky
factors of such matrices.

Tolerances (fp32; the JAX package runs with x64 off): rtol 1e-5, atol
1e-5 for products; rtol 1e-4, atol 1e-5 for the factorizations, solves
and their gradients (LAPACK in torch and in jaxlib order their sums
differently); atol 1e-4 for ``syevd``, whose gradient divides by the
eigenvalue gaps. ``gelqf``'s and ``syevd``'s outputs are unique only up to
the sign of each row of Q (column of L) and of each eigenvector: both
sides are compared after the same normalisation (diag(L) > 0; each
eigenvector's largest component > 0), and their gradients only where
the two packages chose the same signs, which the test checks.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from torch_op_parity import assert_close, both

torch.set_num_threads(2)

PROD = (1e-5, 1e-5)
FACT = (1e-4, 1e-5)
# syevd's gradient divides by the gaps between eigenvalues (1/(w_i -
# w_j)): its rounding differences grow by |w| / gap, about 10 here.
EIG = (1e-4, 1e-4)


def _rng(seed):
    return np.random.RandomState(seed)


def _mat(seed, *shape):
    return (_rng(seed).rand(*shape) * 2 - 1).astype(np.float32)


def _spd(seed, b=2, n=4):
    m = _mat(seed, b, n, n).astype(np.float64)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _chol(seed, b=2, n=4):
    return np.linalg.cholesky(_spd(seed, b, n).astype(np.float64)) \
        .astype(np.float32)


# op -> [(tag, inputs, attrs, wrt, heads, tol)]
CASES = {
    "gemm": [
        ("", lambda: [_mat(1, 2, 3, 4), _mat(2, 2, 4, 5), _mat(3, 2, 3, 5)],
         {}, (0, 1, 2), (0,), PROD),
        ("tt", lambda: [_mat(4, 2, 4, 3), _mat(5, 2, 5, 4), _mat(6, 2, 3, 5)],
         {"transpose_a": True, "transpose_b": True, "alpha": 0.5,
          "beta": -2.0}, (0, 1, 2), (0,), PROD)],
    "gemm2": [
        ("", lambda: [_mat(7, 2, 3, 4), _mat(8, 2, 4, 5)], {}, (0, 1), (0,),
         PROD),
        ("tb", lambda: [_mat(9, 3, 4), _mat(10, 5, 4)],
         {"transpose_b": True, "alpha": 3.0}, (0, 1), (0,), PROD)],
    "potrf": [
        ("lower", lambda: [_spd(11)], {}, (0,), (0,), FACT),
        ("upper", lambda: [_spd(12)], {"lower": False}, (0,), (0,), FACT)],
    "potri": [
        ("lower", lambda: [_chol(13)], {}, (0,), (0,), FACT),
        ("upper", lambda: [_chol(14).transpose(0, 2, 1).copy()],
         {"lower": False}, (0,), (0,), FACT)],
    "trsm": [
        ("", lambda: [_chol(15), _mat(16, 2, 4, 3)], {}, (0, 1), (0,), FACT),
        ("trans_alpha", lambda: [_chol(17), _mat(18, 2, 4, 3)],
         {"transpose": True, "alpha": 2.0}, (0, 1), (0,), FACT),
        ("right", lambda: [_chol(19), _mat(20, 2, 3, 4)],
         {"rightside": True}, (0, 1), (0,), FACT),
        ("right_trans_upper",
         lambda: [_chol(21).transpose(0, 2, 1).copy(), _mat(22, 2, 3, 4)],
         {"rightside": True, "transpose": True, "lower": False}, (0, 1),
         (0,), FACT)],
    "trmm": [
        ("", lambda: [_mat(23, 2, 4, 4), _mat(24, 2, 4, 3)], {}, (0, 1),
         (0,), PROD),
        ("right_trans_upper", lambda: [_mat(25, 2, 4, 4), _mat(26, 2, 3, 4)],
         {"rightside": True, "transpose": True, "lower": False,
          "alpha": -1.5}, (0, 1), (0,), PROD)],
    "syrk": [
        ("", lambda: [_mat(27, 2, 3, 4)], {"alpha": 2.0}, (0,), (0,), PROD),
        ("trans", lambda: [_mat(28, 2, 3, 4)], {"transpose": True}, (0,),
         (0,), PROD)],
    "sumlogdiag": [("", lambda: [_spd(29)], {}, (0,), (0,), FACT)],
    "gelqf": [("", lambda: [_mat(30, 2, 3, 5)], {}, (0,), (0, 1), FACT)],
    "syevd": [("", lambda: [_spd(31)], {}, (0,), (0, 1), EIG)],
    "inverse": [("", lambda: [_spd(32)], {}, (0,), (0,), FACT)],
    "det": [("", lambda: [_spd(33, n=3) / 3], {}, (0,), (0,), FACT)],
    "slogdet": [("", lambda: [_spd(34) * np.float32(-1)], {}, (0,), (1,),
                 FACT)],
}

NAMES = [(prefix + op, i) for op in sorted(CASES)
         for prefix in ("_linalg_", "linalg_")
         for i in range(len(CASES[op]))]


def _id(case):
    name, i = case
    tag = CASES[name.split("linalg_")[1]][i][0]
    return name + ("-" + tag if tag else "")


def _normalize(op, outs):
    """gelqf: diag(L) > 0; syevd: each eigenvector's largest component
    > 0. Returns the outputs so normalised and the signs applied."""
    if op == "gelqf":
        L, Q = outs
        s = np.sign(np.diagonal(L, axis1=-2, axis2=-1))
        return [L * s[..., None, :], Q * s[..., :, None]], s
    if op == "syevd":
        U, w = outs
        idx = np.abs(U).argmax(axis=-1)
        s = np.sign(np.take_along_axis(U, idx[..., None], -1))[..., 0]
        return [U * s[..., :, None], w], s
    return outs, None


@pytest.mark.parametrize("case", NAMES, ids=[_id(c) for c in NAMES])
def test_linalg_op_equals_jax(case):
    name, i = case
    op = name.split("linalg_")[1]
    _, make, attrs, wrt, heads, (rtol, atol) = CASES[op][i]
    (want, want_g), (got, got_g) = both(name, make(), attrs, wrt, heads)
    assert len(got) == len(want)
    want_n, want_s = _normalize(op, want)
    got_n, got_s = _normalize(op, got)
    assert_close(got_n, want_n, rtol, atol, name)
    # The gradients follow the signs each package chose: compare them
    # where LAPACK in both chose the same (on this host it does).
    if want_s is not None:
        assert np.array_equal(want_s, got_s), (want_s, got_s)
    assert_close(got_g, want_g, rtol, atol, name + " grad")


def test_gelqf_and_syevd_invariants():
    """The sign-free facts on the port's outputs: L Q = A with Q's rows
    orthonormal and L lower triangular; U^T diag(w) U = A with U
    orthogonal."""
    a = _mat(40, 3, 4, 6)
    with mx.cpu():
        L, Q = mx.nd.linalg.gelqf(mx.nd.array(a, ctx=mx.cpu()))
    L, Q = L.asnumpy().astype(np.float64), Q.asnumpy().astype(np.float64)
    np.testing.assert_allclose(L @ Q, a, atol=1e-5)
    np.testing.assert_allclose(Q @ Q.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(4), (3, 4, 4)),
                               atol=1e-5)
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))
    s = _spd(41, 3, 5)
    with mx.cpu():
        U, w = mx.nd.linalg.syevd(mx.nd.array(s, ctx=mx.cpu()))
    U, w = U.asnumpy().astype(np.float64), w.asnumpy().astype(np.float64)
    np.testing.assert_allclose(U.transpose(0, 2, 1) @ (w[..., None] * U), s,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(U @ U.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(5), (3, 5, 5)),
                               atol=1e-5)
    assert np.all(np.diff(w, axis=-1) > 0)


KR = [("two", lambda: [_mat(50, 3, 4), _mat(51, 2, 4)]),
      ("three", lambda: [_mat(52, 3, 4), _mat(53, 2, 4), _mat(54, 5, 4)])]


@pytest.mark.parametrize("tag,make", KR, ids=[k[0] for k in KR])
def test_khatri_rao_equals_jax(tag, make):
    inputs = make()
    wrt = tuple(range(len(inputs)))
    (want, want_g), (got, got_g) = both("khatri_rao", inputs, {}, wrt)
    assert_close(got, want, *PROD, what="khatri_rao")
    assert_close(got_g, want_g, *PROD, what="khatri_rao grad")


# nd.linalg: each function of mxnet_tpu/ndarray/linalg.py, forward.
ND = [("gemm", [_mat(60, 3, 4), _mat(61, 4, 2), _mat(62, 3, 2)],
       {"transpose_a": False, "alpha": 2.0, "beta": 0.5}),
      ("gemm2", [_mat(63, 3, 4), _mat(64, 3, 4)], {"transpose_a": True}),
      ("potrf", [_spd(65, 1)[0]], {"lower": True}),
      ("potri", [_chol(66, 1)[0]], {}),
      ("trsm", [_chol(67, 1)[0], _mat(68, 4, 2)], {"alpha": 0.5}),
      ("trmm", [_mat(69, 4, 4), _mat(70, 2, 4)], {"rightside": True}),
      ("syrk", [_mat(71, 3, 4)], {"transpose": True, "alpha": 1.5}),
      ("sumlogdiag", [_spd(72, 1)[0]], {}),
      ("gelqf", [_mat(73, 2, 4)], {}),
      ("syevd", [_spd(74, 1)[0]], {}),
      ("inverse", [_spd(75, 1)[0]], {}),
      ("det", [_spd(76, 1, 3)[0] / 3], {}),
      ("slogdet", [_spd(77, 1)[0]], {})]


@pytest.mark.parametrize("fn,inputs,kw", ND, ids=[c[0] for c in ND])
def test_nd_linalg_function_equals_jax(fn, inputs, kw):
    want = getattr(jmx.nd.linalg, fn)(*[jmx.nd.array(x) for x in inputs],
                                      **kw)
    with mx.cpu():
        got = getattr(mx.nd.linalg, fn)(
            *[mx.nd.array(x, ctx=mx.cpu()) for x in inputs], **kw)
    want = [w.asnumpy() for w in (want if isinstance(want, tuple)
                                  else (want,))]
    got = [g.asnumpy() for g in (got if isinstance(got, tuple) else (got,))]
    assert_close(_normalize(fn, got)[0], _normalize(fn, want)[0], *FACT,
                 what=fn)


def test_nd_linalg_names_are_the_jax_packages():
    import mxnet_tpu.ndarray.linalg as jl

    import mxnet_tpu_torch.ndarray.linalg as tl

    assert tl.__all__ == jl.__all__
    assert sorted(c[0] for c in ND) == sorted(jl.__all__)
