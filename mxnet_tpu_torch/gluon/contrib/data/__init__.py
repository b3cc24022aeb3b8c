"""gluon.contrib.data (counterpart of ``mxnet_tpu/gluon/contrib/data``)."""
from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
