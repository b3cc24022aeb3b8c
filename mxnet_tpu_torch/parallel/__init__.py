"""Training over a device mesh (counterpart of ``mxnet_tpu/parallel/``).

- ``dist``: the process group over torch.distributed (``DMLC_*``
  contract; NCCL on cards, gloo on the host); ``launch`` starts a
  group, or a parameter-server job, on this host.
- ``make_mesh``: named axes over one device, or over the ranks of the
  group, with one subgroup per axis.
- ``TrainStep``: the whole training step on one device, or data
  parallel over a ``dp`` mesh of ranks (global-batch loss and
  BatchNorm statistics, gradients summed over ``dp``,
  ``deterministic_reduction``).
- ``ring_attention``/``ring_self_attention``: exact attention over a
  sequence split on the ``sp`` ranks, K/V rotating by send/recv;
  ``blockwise_attention`` on one device.

Tensor parallelism (a ``tp`` axis larger than 1) is ROADMAP Queue 1
item 7b.
"""
from . import dist
from .mesh import (Mesh, make_mesh, data_sharding, replicate, shard_params,
                   P, NamedSharding)
from .train_step import TrainStep
from .ring_attention import (ring_attention, ring_self_attention,
                             blockwise_attention)

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate",
           "shard_params", "P", "NamedSharding", "TrainStep",
           "ring_attention", "ring_self_attention", "blockwise_attention",
           "dist"]
