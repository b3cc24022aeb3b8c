"""The RNG operators of ``mxnet_tpu/ops/random_ops.py`` and ``nd.random``
in the port.

The two packages draw from different generators, so no draw is compared
across them. Against the JAX package: each name's output shapes and
dtypes, and its parameter semantics (a ``sample_*`` op draws one set per
parameter row: the row means and ranges follow the row's parameters in
both packages alike). In the port alone: each distribution against its
law, on 2 * 10^5 draws at a fixed seed (so the verdict is deterministic),
by its first two moments and a Kolmogorov-Smirnov (continuous laws) or
chi-square (discrete laws) test from ``scipy.stats`` at p > 1e-4, and
``mx.random.seed(s)`` replaying a stream bit for bit.

``normal_like`` is the reference's (N(loc, scale) of its input's shape);
the JAX package's alias of it to ``normal`` fails on an input array
(ROADMAP Queue 3), so it is held to its law only.
"""
import math

import numpy as np
import pytest
import scipy.stats as st
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import _invoke as j_invoke
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray.ndarray import _invoke as t_invoke
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

N = 200_000
P_MIN = 1e-4

ROWS = np.array([0.5, 2.0, 7.5], np.float32)

# name -> (inputs, attrs): one call of each RNG name, small.
CALLS = {}
for _n in ["_random_uniform", "random_uniform", "uniform"]:
    CALLS[_n] = ([], {"low": -2.0, "high": 3.0, "shape": (4, 5)})
for _n in ["_random_normal", "random_normal", "normal"]:
    CALLS[_n] = ([], {"loc": 1.0, "scale": 2.0, "shape": (4, 5)})
for _n in ["_random_gamma", "random_gamma"]:
    CALLS[_n] = ([], {"alpha": 2.5, "beta": 0.5, "shape": (4, 5)})
for _n in ["_random_exponential", "random_exponential"]:
    CALLS[_n] = ([], {"lam": 2.0, "shape": (4, 5)})
for _n in ["_random_poisson", "random_poisson"]:
    CALLS[_n] = ([], {"lam": 3.0, "shape": (4, 5)})
for _n in ["_random_negative_binomial", "random_negative_binomial"]:
    CALLS[_n] = ([], {"k": 3, "p": 0.4, "shape": (4, 5)})
for _n in ["_random_generalized_negative_binomial",
           "random_generalized_negative_binomial"]:
    CALLS[_n] = ([], {"mu": 2.0, "alpha": 0.5, "shape": (4, 5)})
for _n in ["_random_randint", "random_randint", "randint"]:
    CALLS[_n] = ([], {"low": -3, "high": 7, "shape": (4, 5)})
for _n in ["sample_multinomial", "_sample_multinomial", "multinomial"]:
    CALLS[_n] = ([np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]],
                           np.float32)], {"shape": (2, 3),
                                          "get_prob": True})
for _n in ["_shuffle", "shuffle"]:
    CALLS[_n] = ([np.arange(12, dtype=np.float32).reshape(6, 2)], {})
CALLS["_sample_unique_zipfian"] = ([], {"range_max": 50, "shape": (7,)})
for _n in ["_sample_uniform", "sample_uniform"]:
    CALLS[_n] = ([ROWS, ROWS + 1.0], {"shape": (4,)})
for _n in ["_sample_normal", "sample_normal"]:
    CALLS[_n] = ([ROWS * 10, ROWS], {"shape": (4,)})
for _n in ["_sample_gamma", "sample_gamma"]:
    CALLS[_n] = ([ROWS, ROWS], {"shape": (4,)})
for _n in ["_sample_exponential", "sample_exponential"]:
    CALLS[_n] = ([ROWS], {"shape": (4,)})
for _n in ["_sample_poisson", "sample_poisson"]:
    CALLS[_n] = ([ROWS], {"shape": (4,)})


def _port(name, inputs, attrs):
    with mx.cpu():
        out = t_invoke(name, [mx.nd.array(x, ctx=mx.cpu()) for x in inputs],
                       **attrs)
    return out if isinstance(out, tuple) else (out,)


def _jax(name, inputs, attrs):
    out = j_invoke(name, [jmx.nd.array(x) for x in inputs], **attrs)
    return out if isinstance(out, tuple) else (out,)


def test_every_rng_name_has_a_call():
    names = {n for n, op in jreg.OP_REGISTRY.items()
             if op.fn.__module__.endswith("random_ops")}
    assert len(names) == 36
    assert set(CALLS) | {"normal_like"} == names
    assert all(treg.get(n).needs_rng for n in names)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_shape_and_dtype_equal_jax(name):
    inputs, attrs = CALLS[name]
    got, want = _port(name, inputs, attrs), _jax(name, inputs, attrs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # The port keeps int64 where the JAX package (x64 off) narrows
        # to int32 (ROADMAP Queue 3).
        assert g.dtype == w.dtype or (g.dtype, w.dtype) == (
            np.dtype(np.int64), np.dtype(np.int32)), (g.dtype, w.dtype)


def _rows(pkg_run, name, inputs, n=4000):
    out = pkg_run(name, inputs, {"shape": (n,)})[0].asnumpy()
    return out.mean(axis=1), out.min(axis=1), out.max(axis=1)


@pytest.mark.parametrize("name,inputs,mean,lo,hi", [
    ("_sample_uniform", [ROWS, ROWS * 2], 1.5 * ROWS, ROWS, 2 * ROWS),
    ("_sample_normal", [ROWS * 10, ROWS * 0.1], ROWS * 10, None, None),
    ("_sample_gamma", [ROWS, np.float32([1, 2, 3])],
     ROWS * np.float32([1, 2, 3]), 0, None),
    ("_sample_exponential", [ROWS], 1 / ROWS, 0, None),
    ("_sample_poisson", [ROWS], ROWS, 0, None),
])
def test_sample_ops_take_one_row_of_parameters_per_row(name, inputs, mean,
                                                       lo, hi):
    """Both packages: row i of the output follows parameters i."""
    for run in (_port, _jax):
        m, mn, mx_ = _rows(run, name, inputs)
        np.testing.assert_allclose(m, mean, rtol=0.1)
        if lo is not None:
            assert np.all(mn >= np.broadcast_to(lo, mn.shape))
        if hi is not None:
            assert np.all(mx_ < np.broadcast_to(hi, mx_.shape))


def test_multinomial_rows_and_probabilities_equal_jax():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    for run in (_port, _jax):
        s, lp = run("sample_multinomial", [probs], {"shape": 2000,
                                                    "get_prob": True})
        s, lp = s.asnumpy(), lp.asnumpy()
        assert s.shape == (2, 2000)
        assert not np.any(s[1] == 2)      # a zero probability never drawn
        np.testing.assert_allclose(
            lp, np.log(np.maximum(probs[np.arange(2)[:, None], s], 1e-37)),
            rtol=1e-6)
        one = run("sample_multinomial", [probs[0]], {"shape": 1})[0]
        assert one.shape == ()


def test_shuffle_permutes_rows_as_jax_does():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    for run in (_port, _jax):
        y = run("_shuffle", [x], {})[0].asnumpy()
        np.testing.assert_array_equal(y[:, 1] - y[:, 0], 1)
        np.testing.assert_array_equal(np.sort(y[:, 0]), x[:, 0])


def _draw(name, inputs=(), **attrs):
    mx.random.seed(1234)
    return _port(name, list(inputs), attrs)[0].asnumpy().astype(np.float64)


def _ks(x, cdf):
    p = st.kstest(x, cdf).pvalue
    assert p > P_MIN, p


def _chi2(x, pmf, support):
    """Chi-square of the counts of `support` against `pmf`, the tail
    beyond `support` pooled into one cell."""
    counts = np.array([np.sum(x == k) for k in support] +
                      [np.sum(~np.isin(x, support))], np.float64)
    probs = np.array([pmf(k) for k in support], np.float64)
    probs = np.append(probs, max(1.0 - probs.sum(), 0.0))
    keep = probs * len(x) > 5
    f_obs = np.append(counts[keep], counts[~keep].sum())
    f_exp = np.append(probs[keep], probs[~keep].sum()) * len(x)
    if f_exp[-1] == 0:
        f_obs, f_exp = f_obs[:-1], f_exp[:-1]
    p = st.chisquare(f_obs, f_exp * f_obs.sum() / f_exp.sum()).pvalue
    assert p > P_MIN, p


def _moments(x, mean, var, rtol=0.02):
    np.testing.assert_allclose(x.mean(), mean, rtol=rtol,
                               atol=rtol * math.sqrt(var))
    np.testing.assert_allclose(x.var(), var, rtol=4 * rtol)


def test_uniform_law():
    x = _draw("_random_uniform", low=-2.0, high=3.0, shape=(N,))
    assert x.min() >= -2.0 and x.max() < 3.0
    _moments(x, 0.5, 25 / 12)
    _ks(x, st.uniform(-2.0, 5.0).cdf)


def test_normal_law():
    x = _draw("_random_normal", loc=1.0, scale=2.0, shape=(N,))
    _moments(x, 1.0, 4.0)
    _ks(x, st.norm(1.0, 2.0).cdf)


def test_normal_like_law():
    x = _draw("normal_like", [np.zeros((N // 100, 100), np.float32)],
              loc=-1.0, scale=0.5).ravel()
    _moments(x, -1.0, 0.25)
    _ks(x, st.norm(-1.0, 0.5).cdf)


@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, 9.0])
def test_gamma_law(alpha):
    x = _draw("_random_gamma", alpha=alpha, beta=0.5, shape=(N,))
    assert x.min() >= 0
    _moments(x, alpha * 0.5, alpha * 0.25)
    _ks(x, st.gamma(alpha, scale=0.5).cdf)


def test_exponential_law():
    x = _draw("_random_exponential", lam=2.0, shape=(N,))
    _moments(x, 0.5, 0.25)
    _ks(x, st.expon(scale=0.5).cdf)


@pytest.mark.parametrize("lam", [0.7, 3.0, 40.0])
def test_poisson_law(lam):
    x = _draw("_random_poisson", lam=lam, shape=(N,))
    _moments(x, lam, lam)
    _chi2(x, st.poisson(lam).pmf, np.arange(int(lam * 3 + 10)))


def test_negative_binomial_law():
    k, p = 3, 0.4
    x = _draw("_random_negative_binomial", k=k, p=p, shape=(N,))
    law = st.nbinom(k, p)
    _moments(x, law.mean(), law.var())
    _chi2(x, law.pmf, np.arange(40))


def test_generalized_negative_binomial_law():
    """Mean mu, variance mu + alpha mu^2: NB(1/alpha, 1/(1 + alpha mu))."""
    mu, alpha = 2.0, 0.5
    x = _draw("_random_generalized_negative_binomial", mu=mu, alpha=alpha,
              shape=(N,))
    law = st.nbinom(1 / alpha, 1 / (1 + alpha * mu))
    _moments(x, mu, mu + alpha * mu * mu)
    _chi2(x, law.pmf, np.arange(30))


def test_randint_law():
    x = _draw("_random_randint", low=-3, high=7, shape=(N,))
    assert x.min() == -3 and x.max() == 6
    _chi2(x, lambda k: 0.1, np.arange(-3, 7))


def test_multinomial_law():
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    x = _draw("sample_multinomial", [probs], shape=N)
    _chi2(x, lambda k: probs[int(k)], np.arange(4))


def test_unique_zipfian_law():
    """P(k) = log((k + 2) / (k + 1)) / log(range_max + 1)."""
    r = 100
    x = _draw("_sample_unique_zipfian", range_max=r, shape=(N,))
    assert x.min() >= 0 and x.max() < r
    _chi2(x, lambda k: math.log((k + 2) / (k + 1)) / math.log(r + 1),
          np.arange(r))


@pytest.mark.parametrize("name,inputs,law", [
    ("_sample_uniform", [[-1.0, 2.0], [1.0, 2.5]],
     lambda lo, hi: st.uniform(lo, hi - lo)),
    ("_sample_normal", [[-1.0, 3.0], [0.5, 2.0]],
     lambda mu, sigma: st.norm(mu, sigma)),
    ("_sample_gamma", [[0.6, 4.0], [2.0, 0.5]],
     lambda a, b: st.gamma(a, scale=b)),
    ("_sample_exponential", [[0.5, 3.0]],
     lambda lam: st.expon(scale=1 / lam)),
])
def test_sample_op_rows_follow_their_law(name, inputs, law):
    x = _draw(name, [np.array(p, np.float32) for p in inputs],
              shape=(N // 2,))
    for i in range(2):
        _ks(x[i], law(*[p[i] for p in inputs]).cdf)


def test_sample_poisson_rows_follow_their_law():
    lam = np.array([1.5, 12.0], np.float32)
    x = _draw("_sample_poisson", [lam], shape=(N // 2,))
    for i in range(2):
        _chi2(x[i], st.poisson(lam[i]).pmf, np.arange(40))


def test_shuffle_is_uniform_over_positions():
    """Where element 0 lands, over 20 000 shuffles of 8 rows."""
    mx.random.seed(7)
    x = mx.nd.array(np.arange(8, dtype=np.float32), ctx=mx.cpu())
    pos = [int(np.argmin(mx.nd.random.shuffle(x).asnumpy()))
           for _ in range(20000)]
    _chi2(np.array(pos), lambda k: 1 / 8, np.arange(8))


@pytest.mark.parametrize("name", sorted(set(CALLS) | {"normal_like"}))
def test_seed_replays_the_stream_bit_for_bit(name):
    inputs, attrs = CALLS.get(name, ([np.zeros((3, 4), np.float32)], {}))

    def stream():
        mx.random.seed(42)
        return [o.asnumpy() for _ in range(3)
                for o in _port(name, inputs, attrs)]

    first, again = stream(), stream()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    mx.random.seed(43)
    other = [o.asnumpy() for o in _port(name, inputs, attrs)]
    if name not in ("_shuffle", "shuffle") and first[0].size > 4:
        assert not np.array_equal(first[0], other[0])


def test_nd_random_equals_jax_in_shape_and_dtype():
    """``nd.random``'s functions route as the JAX package's do: scalar
    parameters to ``_random_*``, NDArray parameters to ``_sample_*``."""
    rows = ROWS

    def calls(nd, ctx):
        arr = (lambda a: nd.array(a, ctx=ctx)) if ctx else nd.array
        return [
            nd.random.uniform(0, 2, shape=(3, 2)),
            nd.random.uniform(arr(rows), arr(rows + 1), shape=5),
            nd.random.normal(0, 1, shape=4),
            nd.random.normal(arr(rows), arr(rows), shape=(2, 2)),
            nd.random.randn(2, 3),
            nd.random.gamma(2.0, 1.0, shape=(3,)),
            nd.random.gamma(arr(rows), arr(rows), shape=2),
            nd.random.exponential(2.0, shape=(2, 3)),
            nd.random.exponential(arr(rows), shape=2),
            nd.random.poisson(3.0, shape=(3,)),
            nd.random.poisson(arr(rows), shape=2),
            nd.random.negative_binomial(3, 0.5, shape=(2,)),
            nd.random.generalized_negative_binomial(2.0, 0.5, shape=(2,)),
            nd.random.randint(0, 9, shape=(2, 2)),
            nd.random.multinomial(arr(np.array([[0.3, 0.7]], np.float32)),
                                  shape=3),
            nd.random.shuffle(arr(np.arange(6, dtype=np.float32))),
            nd.random.uniform(shape=None),
        ]

    want = calls(jmx.nd, None)
    mx.random.seed(0)
    with mx.cpu():
        got = calls(mx.nd, mx.cpu())
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        assert g.context == mx.cpu()
