"""Contrib basic layers.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py`` (reference:
python/mxnet/gluon/contrib/nn/basic_layers.py: Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm).
"""
from __future__ import annotations

from .... import ndarray as nd
from ...block import HybridBlock
from ...nn import Sequential, HybridSequential, BatchNorm

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Feed the input to every child, concatenate outputs along `axis`
    (reference basic_layers.py:Concurrent, the Inception-branch
    combinator)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable Concurrent (reference basic_layers.py:
    HybridConcurrent). `forward` is overridden directly, as in the JAX
    package: the Sequential mixin's chaining forward would otherwise
    shadow it. Under ``hybridize()`` each child runs its own CachedOp."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Pass-through (reference basic_layers.py:Identity; useful in
    Concurrent branches)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """Embedding whose gradient is row_sparse (reference
    basic_layers.py:SparseEmbedding): the lookup is Embedding's, and the
    ``row_sparse`` grad_stype sends the weight through the Trainer's lazy
    row-sparse update (``gluon/trainer.py``'s ``_split_row_sparse``) and
    the kvstore's row-sparse push and pull."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype, grad_stype="row_sparse")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return "SparseEmbedding(%d -> %d)" % (self._input_dim,
                                              self._output_dim)


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm (reference
    basic_layers.py:SyncBatchNorm over src/operator/contrib/sync_batch_norm).

    A BatchNorm whose statistics are global wherever the step makes them
    global: inside a data-parallel ``parallel.TrainStep`` every train-mode
    BatchNorm normalises with the global batch's moments
    (``ops.nn.batch_stat_reducer``, a differentiable all-reduce over the
    ``dp`` group), as the JAX package's GSPMD step does. Under
    ``gluon.Trainer`` on one device it is a per-device BatchNorm, as in
    the JAX package. `num_devices` is accepted for API parity and unused.
    """

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
