"""state_dict / load_state_dict adapters for the training front ends.

Counterpart of ``mxnet_tpu/checkpoint/state.py``. One checkpointable
state convention across every training API: a nested dict of arrays
(plus small scalars and bytes) that ``CheckpointManager.save`` copies
and ``restore`` hands back. The keys and sections are the JAX
package's, so a state written by either package restores in the other.

Covered front ends:

* ``module.Module`` — arg/aux params plus the updater's optimizer-state
  pickle (reference save_checkpoint + save_optimizer_states, as one
  object).
* ``gluon.Block`` — flat attribute-path parameter dict (the
  save_parameters naming, portable across prefixes).
* ``gluon.Trainer`` — updater states (momentum, fp32 masters).
* ``parallel.TrainStep`` — its own ``state_dict()``.
* ``data.DataPipeline`` / ``data.ShardedRecordStream`` — the input
  pipeline's delivered-sample watermark.

Arrays keep their dtype: a bfloat16 weight is saved as bfloat16 (the
manager writes its 16-bit words) and restored as bfloat16, where
``asnumpy`` and ``.params`` files widen it. Each snapshot adapter checks
the step-in-progress guard (``checkpoint/guard.py``) and copies what it
returns, so the dict is a snapshot that later steps do not change.

``state_dict(obj)`` dispatches on type; ``load_state_dict(obj, state)``
reverses it. Adapters are also importable individually for composite
states, e.g.::

    mgr.save(step, {"net": block_state(net), "trainer": trainer_state(tr)})
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import guard

__all__ = ["state_dict", "load_state_dict", "module_state",
           "load_module_state", "block_state", "load_block_state",
           "trainer_state", "load_trainer_state"]


def state_dict(obj):
    """Snapshot `obj` (Module / gluon Block / gluon Trainer / TrainStep /
    input pipeline) as a nested dict."""
    from ..module.base_module import BaseModule
    from ..gluon.block import Block
    from ..gluon.trainer import Trainer
    from ..parallel.train_step import TrainStep

    if isinstance(obj, TrainStep):
        return obj.state_dict()
    if isinstance(obj, BaseModule):
        return module_state(obj)
    if isinstance(obj, Trainer):
        return trainer_state(obj)
    if isinstance(obj, Block):
        return block_state(obj)
    if _is_pipeline(obj):
        return obj.state_dict()
    raise TypeError("no state adapter for %r" % type(obj).__name__)


def _is_pipeline(obj):
    # An instance can only exist if its module is already loaded, so an
    # absent module answers False without importing the data stack.
    pipeline = sys.modules.get("mxnet_tpu_torch.data.pipeline")
    reader = sys.modules.get("mxnet_tpu_torch.data.reader")
    kinds = tuple(k for k in (
        pipeline and pipeline.DataPipeline,
        reader and reader.ShardedRecordStream) if k)
    return bool(kinds) and isinstance(obj, kinds)


def load_state_dict(obj, state):
    """Restore a `state_dict` snapshot onto `obj`."""
    from ..module.base_module import BaseModule
    from ..gluon.block import Block
    from ..gluon.trainer import Trainer
    from ..parallel.train_step import TrainStep

    if isinstance(obj, TrainStep):
        obj.load_state_dict(state)
        return
    if isinstance(obj, BaseModule):
        load_module_state(obj, state)
        return
    if isinstance(obj, Trainer):
        load_trainer_state(obj, state)
        return
    if isinstance(obj, Block):
        load_block_state(obj, state)
        return
    if _is_pipeline(obj):
        obj.load_state_dict(state)
        return
    raise TypeError("no state adapter for %r" % type(obj).__name__)


def _snapshot(arr):
    """A private copy of an NDArray's tensor, dtype kept."""
    return arr._data.detach().clone()


def to_tensor(value, device=None, dtype=None):
    """A torch tensor of a restored leaf (numpy, torch tensor or
    NDArray), on `device` in `dtype` (default: the value's own; numpy
    float64 stays float64)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    elif isinstance(getattr(value, "_data", None), torch.Tensor):
        t = value._data.detach()
    else:
        t = torch.from_numpy(np.array(value))
    return t.to(device=device if device is not None else t.device,
                dtype=dtype if dtype is not None else t.dtype, copy=True)


def _ndarray(value, ctx=None, dtype=None):
    from ..context import current_context
    from ..ndarray.ndarray import NDArray

    ctx = ctx if ctx is not None else current_context()
    return NDArray(to_tensor(value, ctx.torch_device, dtype), ctx=ctx)


# -- Module -------------------------------------------------------------------

def module_state(mod, include_optimizer=True):
    guard.check("Module")
    arg_params, aux_params = mod.get_params()
    state = {"kind": "module",
             "arg": {n: _snapshot(v) for n, v in arg_params.items()},
             "aux": {n: _snapshot(v) for n, v in aux_params.items()}}
    if include_optimizer and getattr(mod, "optimizer_initialized", False):
        state["opt_states"] = mod._updater.get_states(
            dump_optimizer=False)
    return state


def load_module_state(mod, state):
    ctx = mod._context[0] if getattr(mod, "_context", None) else None
    arg = {n: _ndarray(v, ctx) for n, v in state.get("arg", {}).items()}
    aux = {n: _ndarray(v, ctx) for n, v in state.get("aux", {}).items()}
    if mod.binded:
        mod.set_params(arg, aux)
    else:
        mod._arg_params = arg
        mod._aux_params = aux
        mod._preload_params = (arg, aux)
    blob = state.get("opt_states")
    if blob is None:
        return
    if getattr(mod, "optimizer_initialized", False):
        mod._updater.set_states(blob)
    else:
        # Natural restore order is restore -> init_optimizer: stash the
        # blob for init_optimizer to apply — silently dropping it would
        # restart momentum at zero and break bit-exact resume.
        mod._preload_opt_state_blob = blob


# -- gluon Block --------------------------------------------------------------

def block_state(net):
    guard.check("Block")
    params = net._collect_params_with_prefix()
    return {"kind": "block",
            "params": {n: _snapshot(p.data()) for n, p in params.items()
                       if p._data is not None}}


def load_block_state(net, state, ctx=None):
    """Set every parameter of `net` from `state`, in the parameter's own
    dtype where it has a value (the saved dtype where it has none)."""
    params = net._collect_params_with_prefix()
    loaded = state.get("params", {})
    for name, p in params.items():
        if name not in loaded:
            raise ValueError("parameter %s missing in checkpoint" % name)
        value = loaded[name]
        if p.shape is None or p._data is None:
            p.shape = tuple(value.shape)
            p.initialize(ctx=ctx)
        live = p.data()
        p.set_data(_ndarray(value, live.context, live._data.dtype))


# -- gluon Trainer ------------------------------------------------------------

def trainer_state(trainer):
    guard.check("Trainer")
    return {"kind": "trainer",
            "opt_states": trainer._updater.get_states(dump_optimizer=False)}


def load_trainer_state(trainer, state):
    trainer._set_states(state["opt_states"])
