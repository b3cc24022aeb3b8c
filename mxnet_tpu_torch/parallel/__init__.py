"""Training over a device mesh (counterpart of ``mxnet_tpu/parallel/``).

This slice ports the single-device part: ``make_mesh`` over one device
and ``TrainStep``, the whole training step (forward, loss, backward and
optimizer update). Multi-device meshes, ``dist`` and ring attention are
ROADMAP Queue 1 item 7.
"""
from .mesh import Mesh, make_mesh, data_sharding, replicate
from .train_step import TrainStep

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate", "TrainStep"]
