"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: Uniform, Normal, Xavier,
MSRAPrelu, Orthogonal, Bilinear, One, Zero, Constant, the recurrent
ones (LSTMBias, FusedRNN) and Mixed, with the reference's name-suffix
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
import re

import numpy as np

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Xavier",
           "MSRAPrelu", "Orthogonal", "Bilinear", "One", "Zero", "Constant",
           "LSTMBias", "FusedRNN", "Mixed", "register", "create"]

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


@register("normal")
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        arr[...] = _rng().normal(0, self.sigma, arr.shape)
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


@register("msra_prelu")
class MSRAPrelu(Xavier):
    """Gaussian Xavier with magnitude 2 / (1 + slope^2) (He et al.'s
    initialization for PReLU nets)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("orthogonal")
class Orthogonal(Initializer):
    """`scale` times an orthonormal basis (the SVD's U or V of a random
    (out, in) matrix, whichever has its shape)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        rng = _rng()
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[...] = (self.scale * q).reshape(arr.shape)
        return arr


@register("bilinear")
class Bilinear(Initializer):
    """Bilinear upsampling kernels for a (C, 1, k, k) deconvolution."""

    def _init_weight(self, desc, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(arr.size)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr[...] = weight.reshape(shape)
        return arr


# dumps() writes "ones" and "zeros", the JAX package's names.
@register("one")
@register("ones")
class One(Initializer):
    def _init_weight(self, desc, arr):
        arr[...] = 1.0
        return arr


@register("zero")
@register("zeros")
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        arr[...] = 0.0
        return arr



@register("constant")
class Constant(Initializer):
    """Every element `value` (a number, or an array that broadcasts)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        arr[...] = np.asarray(self.value.asnumpy()
                              if hasattr(self.value, "asnumpy")
                              else self.value)
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


class Mixed:
    """The initializer of the first of `patterns` (regular expressions,
    matched at the name's start) that the parameter's name matches."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, desc, arr):
        for prog, init in self.map:
            if prog.match(str(desc)):
                return init(desc, arr)
        raise ValueError("no initializer pattern matches %s" % desc)
