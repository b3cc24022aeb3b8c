"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` for the initializers gluon
uses by default (Uniform; One and Zero by name) and Xavier, with the
reference's name-suffix dispatch (``*_weight``,
``*_bias``, ``*_gamma``, ``*_beta``, and BatchNorm's
``*_running_mean``/``*_running_var`` moving stats). Initializers fill
numpy arrays on the host from the (seed, counter) stream of
:mod:`mxnet_tpu_torch.random`; the caller then places them on the
device.
"""
from __future__ import annotations

import numpy as np

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Xavier", "One", "Zero",
           "register", "create"]

_REGISTRY: dict = {}


def register(name):
    """Class decorator: make an initializer creatable by name."""

    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def create(spec):
    """An initializer from a registered name (or the initializer)."""
    if not isinstance(spec, str):
        return spec
    try:
        return _REGISTRY[spec.lower()]()
    except KeyError:
        raise ValueError("unknown initializer %r" % spec) from None


class InitDesc(str):
    """Name + attrs describing what is being initialized."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def _rng():
    """Fresh host RandomState per call, as in the JAX package: the
    counter advances so two same-shaped parameters never draw the same
    weights."""
    seed, counter, _ = _random.get_state()
    _random.advance()
    return np.random.RandomState((seed * 1000003 + counter * 7919) % (2 ** 31))


class Initializer:
    """Base class: dispatches on the parameter name's suffix."""

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__")
        if init:
            return create(init)._init_weight(desc, arr)
        name = desc.lower()
        if name.endswith("weight"):
            return self._init_weight(desc, arr)
        if name.endswith("bias"):
            return self._init_bias(desc, arr)
        if name.endswith("gamma"):
            return self._init_one(desc, arr)
        if name.endswith("beta"):
            return self._init_zero(desc, arr)
        if name.endswith("running_mean") or name.endswith("moving_mean"):
            return self._init_zero(desc, arr)
        if name.endswith("running_var") or name.endswith("moving_var"):
            return self._init_one(desc, arr)
        return self._init_weight(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_bias(self, desc, arr):
        arr[...] = 0.0
        return arr

    def _init_one(self, desc, arr):
        arr[...] = 1.0
        return arr

    def _init_zero(self, desc, arr):
        arr[...] = 0.0
        return arr


@register("uniform")
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, desc, arr):
        arr[...] = _rng().uniform(-self.scale, self.scale, arr.shape)
        return arr


@register("xavier")
class Xavier(Initializer):
    """rnd_type uniform/gaussian, factor_type avg/in/out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2, got %s for %s"
                             % (shape, desc))
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[...] = _rng().uniform(-scale, scale, shape)
        else:
            arr[...] = _rng().normal(0, scale, shape)
        return arr


@register("ones")
@register("one")
class One(Initializer):
    def _init_weight(self, desc, arr):
        arr[...] = 1.0
        return arr


@register("zeros")
@register("zero")
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        arr[...] = 0.0
        return arr

