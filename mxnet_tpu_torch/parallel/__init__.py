"""Training over a device mesh (counterpart of ``mxnet_tpu/parallel/``).

- ``dist``: the process group over torch.distributed (``DMLC_*``
  contract; NCCL on cards, gloo on the host); ``launch`` starts a
  group, or a parameter-server job, on this host.
- ``make_mesh``: named axes over one device, or over the ranks of the
  group, with one subgroup per axis.
- ``shard_params``/``place``/``gather``: each parameter's placement
  spec by the Megatron rule, this rank's block of a full array, and the
  full array from the ranks' blocks.
- ``TrainStep``: the whole training step on one device, or over a mesh
  of ranks: data parallel over ``dp`` (global-batch loss and BatchNorm
  statistics, gradients summed over ``dp``,
  ``deterministic_reduction``) and tensor parallel over ``tp`` (each
  rank holds its block of the split parameters and of their optimizer
  state; sharded checkpoints).
- ``ring_attention``/``ring_self_attention``: exact attention over a
  sequence split on the ``sp`` ranks, K/V rotating by send/recv;
  ``blockwise_attention`` on one device.

A mesh of several devices in one process is not built: the port runs
one device per process (``launch``).
"""
from . import dist
from .mesh import (Mesh, make_mesh, data_sharding, replicate, shard_params,
                   P, NamedSharding, place, gather)
from .train_step import TrainStep
from .ring_attention import (ring_attention, ring_self_attention,
                             blockwise_attention)

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate",
           "shard_params", "P", "NamedSharding", "place", "gather",
           "TrainStep",
           "ring_attention", "ring_self_attention", "blockwise_attention",
           "dist"]
