"""Random sampling operators.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (reference
src/operator/random/: sample_op.cc, multinomial_op.h, shuffle_op.cc).
Every op draws from ``generator``, the ``torch.Generator`` of the device
it runs on, which dispatch passes (``needs_rng=True``), so
``mx.random.seed`` replays a stream on the host and on the card alike.
The ``_random_*`` ops make their result from attrs alone and take
``device`` from dispatch; the ``_sample_*`` ops draw one set of samples
per element of their parameter tensors, the set's shape trailing. On
``meta`` (shape inference) nothing is drawn.

The draws differ from the JAX package's (another generator); the laws,
shapes and dtypes are the same. Gamma has no generator-taking sampler
in PyTorch, so it is drawn here by Marsaglia and Tsang's method, on the
device, from the generator's normals and uniforms.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device)


def _tail(shape):
    return tuple(shape) if isinstance(shape, (tuple, list)) else \
        ((shape,) if shape else ())


def _per_row(param, shape):
    """`param` reshaped to broadcast over its trailing sample shape."""
    return param.reshape(tuple(param.shape) + (1,) * len(_tail(shape)))


def standard_gamma(alpha, generator):
    """Gamma(alpha, 1) draws, one per element of the float tensor
    `alpha` (Marsaglia and Tsang, 2000): d = a - 1/3, c = 1 / sqrt(9d),
    v = (1 + c z)^3 for a standard normal z, accepted when
    log u < z^2 / 2 + d - d v + d log v; the elements still rejected are
    drawn again until none is left. alpha < 1 draws Gamma(alpha + 1) and
    scales by u^(1 / alpha)."""
    if alpha.device.type == "meta":
        return torch.empty_like(alpha)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.empty_like(alpha)
    todo = torch.ones_like(alpha, dtype=torch.bool)
    while True:
        z = torch.empty_like(alpha).normal_(generator=generator)
        u = torch.empty_like(alpha).uniform_(generator=generator)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    u = torch.empty_like(alpha).uniform_(generator=generator)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def _poisson(rate, generator):
    if rate.device.type == "meta":
        return torch.empty_like(rate)
    return torch.poisson(rate, generator=generator)


@register("_random_uniform", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_uniform", "uniform"))
def _uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", generator=None,
             device=None):
    return _empty(shape, dtype, device).uniform_(low, high,
                                                 generator=generator)


@register("_random_normal", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_normal", "normal"))
def _normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", generator=None,
            device=None):
    return _empty(shape, dtype, device).normal_(loc, scale,
                                                generator=generator)


@register("normal_like", differentiable=False, needs_rng=True)
def _normal_like(data, loc=0.0, scale=1.0, generator=None):
    """N(loc, scale) draws of `data`'s shape and dtype (the reference's
    normal_like; the JAX package aliases it to normal, ROADMAP Queue 3)."""
    return torch.empty_like(data).normal_(loc, scale, generator=generator)


@register("_random_gamma", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_gamma",))
def _gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", generator=None,
           device=None):
    a = torch.full(tuple(shape), float(alpha), dtype=torch_dtype(dtype),
                   device=device)
    return standard_gamma(a, generator) * beta


@register("_random_exponential", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_exponential",))
def _exponential(lam=1.0, shape=(1,), dtype="float32", generator=None,
                 device=None):
    return _empty(shape, dtype, device).exponential_(lam,
                                                     generator=generator)


@register("_random_poisson", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_poisson",))
def _poisson_op(lam=1.0, shape=(1,), dtype="float32", generator=None,
                device=None):
    rate = torch.full(tuple(shape), float(lam), device=device)
    return _poisson(rate, generator).to(torch_dtype(dtype))


@register("_random_negative_binomial", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_negative_binomial",))
def _neg_binomial(k=1, p=0.5, shape=(1,), dtype="float32", generator=None,
                  device=None):
    """Failures before the k-th success: Poisson(Gamma(k) (1-p)/p)."""
    a = torch.full(tuple(shape), float(k), device=device)
    lam = standard_gamma(a, generator) * ((1 - p) / p)
    return _poisson(lam, generator).to(torch_dtype(dtype))


@register("_random_generalized_negative_binomial", differentiable=False,
          needs_rng=True, creates=True,
          aliases=("random_generalized_negative_binomial",))
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=(1,), dtype="float32",
                      generator=None, device=None):
    """Poisson(Gamma(1/alpha) mu alpha): mean mu, variance
    mu + alpha mu^2."""
    a = torch.full(tuple(shape), 1.0 / alpha, device=device)
    lam = standard_gamma(a, generator) * (mu * alpha)
    return _poisson(lam, generator).to(torch_dtype(dtype))


@register("_random_randint", differentiable=False, needs_rng=True,
          creates=True, aliases=("random_randint", "randint"))
def _randint(low=0, high=1, shape=(1,), dtype="int32", generator=None,
             device=None):
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=generator, dtype=torch_dtype(dtype),
                         device=device)


@register("sample_multinomial", differentiable=False, needs_rng=True,
          aliases=("_sample_multinomial", "multinomial"))
def _multinomial(data, shape=1, get_prob=False, dtype="int32",
                 generator=None):
    """Category draws in proportion to `data`'s last axis, prod(shape)
    per row (a 1-D `data` is one row; ``shape=1`` drops the sample
    axis). `get_prob` adds each draw's log(max(p, 1e-37)), the logit
    the JAX package samples from."""
    n = shape if isinstance(shape, int) else math.prod(shape)
    rows = data.reshape(-1, data.shape[-1])
    if data.device.type == "meta":
        samples = torch.empty((rows.shape[0], n), dtype=torch.int64,
                              device="meta")
    else:
        samples = torch.multinomial(rows, n, replacement=True,
                                    generator=generator)
    logp = torch.take_along_dim(torch.log(torch.clamp(rows, min=1e-37)),
                                samples, dim=-1)
    lead = tuple(data.shape[:-1])
    samples, logp = samples.reshape(lead + (n,)), logp.reshape(lead + (n,))
    if isinstance(shape, int) and shape == 1:
        samples, logp = samples[..., 0], logp[..., 0]
    out = samples.to(torch_dtype(dtype))
    return (out, logp) if get_prob else out


@register("_shuffle", differentiable=False, needs_rng=True,
          aliases=("shuffle",))
def _shuffle(data, generator=None):
    """`data` with its first axis permuted."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", differentiable=False, needs_rng=True,
          creates=True)
def _sample_unique_zipfian(range_max=1, shape=(1,), generator=None,
                           device=None):
    """Log-uniform (Zipfian) int64 classes in [0, range_max):
    floor(exp(u log(range_max + 1))) - 1, as the JAX package draws them
    (with repeats)."""
    u = torch.empty(tuple(shape), device=device).uniform_(
        generator=generator)
    out = (torch.exp(u * math.log(range_max + 1.0)) - 1.0).to(torch.int64)
    return torch.clamp(out, 0, range_max - 1)


@register("_sample_uniform", differentiable=False, needs_rng=True,
          aliases=("sample_uniform",))
def _sample_uniform(low, high, shape=(), dtype="float32", generator=None):
    u = _empty(tuple(low.shape) + _tail(shape), dtype, low.device).uniform_(
        generator=generator)
    lo, hi = _per_row(low, shape), _per_row(high, shape)
    return lo + u * (hi - lo)


@register("_sample_normal", differentiable=False, needs_rng=True,
          aliases=("sample_normal",))
def _sample_normal(mu, sigma, shape=(), dtype="float32", generator=None):
    z = _empty(tuple(mu.shape) + _tail(shape), dtype, mu.device).normal_(
        generator=generator)
    return _per_row(mu, shape) + z * _per_row(sigma, shape)


@register("_sample_gamma", differentiable=False, needs_rng=True,
          aliases=("sample_gamma",))
def _sample_gamma(alpha, beta, shape=(), dtype="float32", generator=None):
    target = tuple(alpha.shape) + _tail(shape)
    a = _per_row(alpha, shape).expand(target).to(torch_dtype(dtype))
    return standard_gamma(a.contiguous(), generator) * _per_row(beta, shape)


@register("_sample_exponential", differentiable=False, needs_rng=True,
          aliases=("sample_exponential",))
def _sample_exponential(lam, shape=(), dtype="float32", generator=None):
    e = _empty(tuple(lam.shape) + _tail(shape), dtype, lam.device)
    return e.exponential_(generator=generator) / _per_row(lam, shape)


@register("_sample_poisson", differentiable=False, needs_rng=True,
          aliases=("sample_poisson",))
def _sample_poisson(lam, shape=(), dtype="float32", generator=None):
    target = tuple(lam.shape) + _tail(shape)
    rate = _per_row(lam, shape).expand(target).to(torch.float32)
    return _poisson(rate.contiguous(), generator).to(torch_dtype(dtype))
