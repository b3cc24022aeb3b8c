"""gluon.contrib.nn (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]
