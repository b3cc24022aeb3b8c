"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` for the initializers gluon
uses by default (Uniform; One and Zero by name), Xavier, and the
recurrent ones (LSTMBias, FusedRNN), with the reference's name-suffix
dispatch (``*_weight``,
``*_bias``, ``*_gamma``, ``*_beta``, and BatchNorm's
``*_running_mean``/``*_running_var`` moving stats). Initializers fill
numpy arrays on the host from the (seed, counter) stream of
:mod:`mxnet_tpu_torch.random`; the caller then places them on the
device. ``dumps()`` gives the JAX package's ``["name", {kwargs}]`` JSON,
the form a symbol variable's ``__init__`` attr holds, and
:func:`create` reads it back.
"""
from __future__ import annotations

import json

import numpy as np

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Xavier", "One", "Zero",
           "LSTMBias", "FusedRNN", "register", "create"]

_REGISTRY: dict = {}


def register(name):
    """Class decorator: make an initializer creatable by name."""

    def deco(cls):
        _REGISTRY[name] = cls
        # The first name registered is the one dumps() writes.
        if "_register_name" not in cls.__dict__:
            cls._register_name = name
        return cls

    return deco


def create(spec):
    """An initializer from a registered name, a ``dumps()`` JSON string,
    or the initializer itself."""
    if not isinstance(spec, str):
        return spec
    name, kwargs = spec.strip(), {}
    if name.startswith("["):
        name, kwargs = json.loads(name)
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError("unknown initializer %r" % spec) from None
    return cls(**kwargs)


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

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``["name", {kwargs}]`` as JSON (reference Initializer.dumps)."""
        name = getattr(type(self), "_register_name",
                       type(self).__name__.lower())
        return json.dumps([name, getattr(self, "_kwargs", {})])

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
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        arr[...] = _rng().uniform(-self.scale, self.scale, arr.shape)
        return arr


@register("xavier")
class Xavier(Initializer):
    """rnd_type uniform/gaussian, factor_type avg/in/out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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



@register("lstmbias")
class LSTMBias(Initializer):
    """Zero biases but the forget gate's, `forget_bias` (reference
    initializer.py:LSTMBias; gates [i, f, g, o])."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        arr[...] = 0.0
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias
        return arr


@register("fused_rnn")
class FusedRNN(Initializer):
    """A fused RNN op's flat parameter vector, block by block (reference
    initializer.py:FusedRNN): each weight from `init` (default
    ``Uniform(0.07)``, as in the JAX package), biases zero but the LSTM
    forget gate's slice of each b_input, `forget_bias`."""

    def __init__(self, init=None, num_hidden=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        init = create(init) if isinstance(init, str) else init
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init or Uniform(0.07)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .ops.rnn_ops import rnn_infer_input_size, rnn_param_layout

        flat = arr.reshape(-1)
        h = self._num_hidden
        in_size = rnn_infer_input_size(flat.shape[0], self._num_layers, h,
                                       self._mode, self._bidirectional)
        for name, shape, off in rnn_param_layout(
                self._num_layers, h, in_size, self._mode,
                self._bidirectional):
            block = np.zeros(shape, dtype=arr.dtype)
            if name.endswith("weight"):
                self._init._init_weight(InitDesc(name), block)
            elif self._mode == "lstm" and name.endswith("i2h_bias"):
                block[h:2 * h] = self._forget_bias
            flat[off:off + block.size] = block.reshape(-1)
        return arr
