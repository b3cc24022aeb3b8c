"""mxnet_tpu_torch.data — streaming input pipeline.

Counterpart of ``mxnet_tpu/data/__init__.py``, with its lazy imports
(:22-57).

Sharded RecordIO streaming, a parallel decode pool, async device
prefetch, and checkpointable iterator state on every stage:

* :mod:`.sharding` — deterministic equal-size wrap-tail shards
  (num_parts that never truncates and never diverges rank step counts).
* :mod:`.reader` — ``RecordDataset`` (one or many .rec files as one
  random-access sample space) + ``ShardedRecordStream``.
* :mod:`.decode` — ``DecodePool`` worker team (ordered/unordered).
* :mod:`.prefetch` — ``DevicePrefetcher``: a producer thread that
  stages each batch in pinned host memory and copies it to the card on
  a side CUDA stream, overlapping the running step;
  ``mx_data_wait_seconds``.
* :mod:`.pipeline` — ``DataPipeline`` tying it together, with
  ``state_dict``/``load_state_dict`` for preemption-safe, data-order
  bit-exact resume, and ``stall_fraction`` over the step-path spans.

Only :mod:`.sharding` loads eagerly (``io.py``/``image.py`` use its
``shard_slice`` and must not drag the pipeline stack into their import).
"""
from __future__ import annotations

from .sharding import epoch_order, shard_indices, shard_slice, num_padded

__all__ = ["epoch_order", "shard_indices", "shard_slice", "num_padded",
           "RecordDataset", "ShardedRecordStream", "DecodePool",
           "DevicePrefetcher", "DataPipeline", "ImageRecordDecoder",
           "stall_fraction", "DecodeAutoscaler", "PinnedStager"]

_LAZY = {
    "RecordDataset": ".reader",
    "ShardedRecordStream": ".reader",
    "DecodePool": ".decode",
    "DevicePrefetcher": ".prefetch",
    "PinnedStager": ".prefetch",
    "DataPipeline": ".pipeline",
    "ImageRecordDecoder": ".pipeline",
    "stall_fraction": ".pipeline",
    "DecodeAutoscaler": ".autoscale",
    "reader": ".reader",
    "decode": ".decode",
    "prefetch": ".prefetch",
    "pipeline": ".pipeline",
    "sharding": ".sharding",
    "autoscale": ".autoscale",
}


def __getattr__(attr):
    target = _LAZY.get(attr)
    if target is None:
        raise AttributeError("module 'mxnet_tpu_torch.data' has no attribute %r"
                             % attr)
    import importlib

    mod = importlib.import_module(target, __name__)
    value = getattr(mod, attr, mod)
    globals()[attr] = value
    return value
