"""`mx.nd.random` (reference: python/mxnet/ndarray/random.py).

Counterpart of ``mxnet_tpu/ndarray/random.py``: each sampler calls the
``_random_*`` operator for scalar parameters and the ``_sample_*`` one
(one set of draws per parameter element) for NDArray parameters. The
draws come from the generator of the device they are made on; `ctx`
(default: the current context) chooses it for the scalar forms.
"""
from __future__ import annotations

from ..context import Context, current_context
from .ndarray import NDArray, _invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _tail(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _shape(shape):
    return (1,) if shape is None else _tail(shape)


def _make(name, ctx, out, **attrs):
    """A scalar-parameter draw on `ctx`."""
    with Context(ctx) if ctx is not None else current_context():
        return _invoke(name, [], out=out, **attrs)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kwargs):
    if isinstance(low, NDArray):
        return _invoke("_sample_uniform", [low, high], shape=_tail(shape),
                       dtype=dtype, out=out)
    return _make("_random_uniform", ctx, out, low=low, high=high,
                 shape=_shape(shape), dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kwargs):
    if isinstance(loc, NDArray):
        return _invoke("_sample_normal", [loc, scale], shape=_tail(shape),
                       dtype=dtype, out=out)
    return _make("_random_normal", ctx, out, loc=loc, scale=scale,
                 shape=_shape(shape), dtype=dtype)


def randn(*shape, dtype="float32", ctx=None, **kwargs):
    return normal(shape=shape or (1,), dtype=dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kwargs):
    if isinstance(alpha, NDArray):
        return _invoke("_sample_gamma", [alpha, beta], shape=_tail(shape),
                       dtype=dtype, out=out)
    return _make("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                 shape=_shape(shape), dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kwargs):
    if isinstance(scale, NDArray):
        return _invoke("_sample_exponential", [1.0 / scale],
                       shape=_tail(shape), dtype=dtype, out=out)
    return _make("_random_exponential", ctx, out, lam=1.0 / scale,
                 shape=_shape(shape), dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None,
            **kwargs):
    if isinstance(lam, NDArray):
        return _invoke("_sample_poisson", [lam], shape=_tail(shape),
                       dtype=dtype, out=out)
    return _make("_random_poisson", ctx, out, lam=lam, shape=_shape(shape),
                 dtype=dtype)


def negative_binomial(k=1, p=1, shape=None, dtype="float32", ctx=None,
                      out=None, **kwargs):
    return _make("_random_negative_binomial", ctx, out, k=k, p=p,
                 shape=_shape(shape), dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None,
                                  **kwargs):
    return _make("_random_generalized_negative_binomial", ctx, out, mu=mu,
                 alpha=alpha, shape=_shape(shape), dtype=dtype)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs):
    return _make("_random_randint", ctx, out, low=low, high=high,
                 shape=_shape(shape), dtype=dtype)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kwargs):
    return _invoke("sample_multinomial", [data], shape=shape,
                   get_prob=get_prob, dtype=dtype)


def shuffle(data, **kwargs):
    return _invoke("_shuffle", [data])
