"""Basic layers: Sequential, HybridSequential, Dense, Dropout, BatchNorm,
Embedding, Activation, Flatten.

Counterpart of the subset of ``mxnet_tpu/gluon/nn/basic_layers.py`` that
ResNet and the language models use. Note the BatchNorm layer's defaults differ from the op's:
the layer passes ``epsilon=1e-5`` and ``fix_gamma=not scale``, the op
defaults to ``eps=1e-3, fix_gamma=True``.
"""
from __future__ import annotations

import numpy as np

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Embedding", "Flatten", "Activation"]


class _SequentialMixin:
    """Container behaviour shared by Sequential and HybridSequential."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class Sequential(_SequentialMixin, Block):
    """Stack of blocks."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """Hybridizable stack of blocks."""


class Dense(HybridBlock):
    """Fully connected layer over the FullyConnected op."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        self.act_type = activation
        self.weight = self.params.get(
            "weight", shape=(units, in_units), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(units,), dtype=dtype,
                                        init=bias_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)
        if self._use_bias:
            self.bias.shape = (self._units,)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act_type:
            out = F.Activation(out, act_type=self.act_type)
        return out


class Dropout(HybridBlock):
    """Dropout of rate `rate` in training, shared along `axes`; the
    identity in eval mode."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization; the running stats are parameters that train
    mode updates (captured and committed by a hybridized call)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = self.params.get("gamma", shape=shape,
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=shape,
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get("running_mean", shape=shape,
                                            grad_req="null",
                                            init=running_mean_initializer,
                                            allow_deferred_init=True)
        self.running_var = self.params.get("running_var", shape=shape,
                                           grad_req="null",
                                           init=running_variance_initializer,
                                           allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd

        training = autograd.is_training()
        res = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if not isinstance(res, tuple):
            # Symbolic trace (export): one node; the Executor routes the
            # running-stat updates to the aux states.
            return res
        out, new_mean, new_var = res
        if training and not self._use_global_stats:
            self.running_mean.set_data(new_mean)
            self.running_var.set_data(new_var)
        return out


class Embedding(HybridBlock):
    """Rows of an (input_dim, output_dim) weight at integer indices
    (clipped into range, as the op clips them)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype, grad_stype="row_sparse" if sparse_grad
            else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return getattr(self, "_act_type", "activation")

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
