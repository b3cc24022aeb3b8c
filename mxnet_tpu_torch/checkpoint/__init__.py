"""mxnet_tpu_torch.checkpoint — fault-tolerant async checkpointing.

Counterpart of ``mxnet_tpu/checkpoint/``. The training-side durability
subsystem: atomic-commit checkpoint directories written off the critical
path, integrity-verified restore that always lands on the last fully
committed step, sharded per-process saves, and a preemption hook that
turns SIGTERM into one final synchronous save. The on-disk format is the
JAX package's: a directory committed by either package restores in the
other.

Quick start::

    from mxnet_tpu_torch import checkpoint

    mgr = checkpoint.CheckpointManager("ckpt/", keep_last=3, keep_every=100)
    step = parallel.TrainStep(net, loss_fn, ...)
    hook = checkpoint.PreemptionHook(
        mgr, state_fn=step.state_dict,
        step_fn=lambda: step.num_update).install()

    start = 0
    if mgr.latest_step() is not None:
        start, state = mgr.restore()
        step.load_state_dict(state)
    for s in range(start, num_steps):
        loss = step(x, y)
        mgr.save(s + 1, step.state_dict())    # async
    mgr.close()
"""
from .manager import CheckpointManager, Shard, CheckpointNotFoundError, \
    CheckpointCorruptError
from .guard import StepInProgressError
from .preempt import PreemptionHook
from .state import state_dict, load_state_dict, module_state, \
    load_module_state, block_state, load_block_state, trainer_state, \
    load_trainer_state

__all__ = ["CheckpointManager", "Shard", "CheckpointNotFoundError",
           "CheckpointCorruptError", "StepInProgressError",
           "PreemptionHook", "state_dict", "load_state_dict",
           "module_state", "load_module_state", "block_state",
           "load_block_state", "trainer_state", "load_trainer_state"]
