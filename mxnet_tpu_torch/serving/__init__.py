"""mxnet_tpu_torch.serving — shape-bucketed batching inference.

Counterpart of ``mxnet_tpu/serving``. The deployment story of the
reference (Module ``bind(for_training=False)`` + save/load_checkpoint):
one CachedOp signature per batch-size bucket, each run once at warmup; a
dynamic micro-batcher coalescing concurrent requests under a latency
deadline; bounded-queue admission with deadline shedding; per-bucket
stats in ``mx.profiler.dumps()``.

Single model::

    srv = serving.InferenceServer(fn, params, item_shape=(784,),
                                  max_batch=32, max_delay_ms=5)
    fut = srv.submit(x)          # x: (k, *item_shape), k <= max_batch
    y = fut.result()             # or srv.predict(x)
    srv.shutdown()               # or use `with serving.InferenceServer(...)`

Many models — the gateway (one admission pool, fair-share scheduling,
per-model SLO shedding, quantized/mesh-sharded variants, zero-drop hot
reload)::

    gw = serving.ModelGateway()
    gw.register(serving.ModelSpec("mnist", fn=f, params=w,
                                  item_shape=(784,), weight=2.0,
                                  slo=(0.99, 0.250)))
    res = gw.predict("mnist", x)         # GatewayResult: .output,
    serving.hot_swap(gw, "mnist", params=w2)   # .generation, .model
    gw.shutdown()

Stateful sequence models (continuous batching — iteration-level slot
scheduling with paged per-slot state, :mod:`.continuous`)::

    gw.register(serving.ModelSpec(
        "lm", decode=serving.DecodeConfig(step, state_shape=(64,)),
        max_batch=16))
    seq = gw.generate("lm", prompt_ids)  # SequenceResult: .tokens,
    gw.shutdown()                        # .ttft_s, .generation
"""
from .admission import AdmissionController, DeadlineExceededError, \
    QueueFullError, ServiceUnavailableError
from .batcher import DynamicBatcher
from .buckets import BucketPolicy
from .continuous import DecodeConfig, DecodeLoop, PagedSlotAllocator, \
    SequenceResult
from .engine import InferenceServer
from .gateway import GatewayResult, ModelGateway
from .metrics import ServingMetrics
from .registry import MeshShardedModel, ModelRegistry, ModelSpec, \
    QuantizedFnModel
from .reload import hot_swap

__all__ = ["InferenceServer", "BucketPolicy", "DynamicBatcher",
           "ServingMetrics", "AdmissionController", "QueueFullError",
           "DeadlineExceededError", "ServiceUnavailableError",
           "ModelGateway", "GatewayResult", "ModelRegistry", "ModelSpec",
           "QuantizedFnModel", "MeshShardedModel", "hot_swap",
           "DecodeConfig", "DecodeLoop", "PagedSlotAllocator",
           "SequenceResult"]
