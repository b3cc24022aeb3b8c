"""mxnet_tpu_torch.serving — shape-bucketed batching inference.

Counterpart of the single-model server of ``mxnet_tpu/serving``::

    srv = serving.InferenceServer(fn, params, item_shape=(3, 224, 224),
                                  buckets=(1, 8, 32), max_delay_ms=5)
    y = srv.predict(x)           # x: (k, *item_shape), k <= max_batch
    srv.shutdown()

The gateway, continuous batching and hot reload come with later slices.
"""
from .admission import AdmissionController, DeadlineExceededError, \
    QueueFullError
from .batcher import DynamicBatcher
from .buckets import BucketPolicy
from .engine import InferenceServer
from .metrics import ServingMetrics

__all__ = ["InferenceServer", "BucketPolicy", "DynamicBatcher",
           "ServingMetrics", "AdmissionController", "QueueFullError",
           "DeadlineExceededError"]
