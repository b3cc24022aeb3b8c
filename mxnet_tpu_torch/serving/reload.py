"""Hot model reload — zero-drop version swaps for the gateway.

Counterpart of ``mxnet_tpu/serving/reload.py`` (a copy: it imports no
JAX). The protocol (training commits flow into serving without
restarts):

1. **Load** the new version's weights — directly (``params=`` /
   ``checkpoint=``+``epoch=``), or from a training job's committed
   checkpoint via ``manager=`` (:meth:`CheckpointManager.restore`
   always lands on the last fully committed step; ``extract=`` maps
   the training state_dict to the spec's serving params).
2. **Warm off-path**: the new backend's FULL bucket ladder runs once on
   the caller's thread while the old generation keeps serving, so the
   first post-swap request of each bucket pays no first-signature cost.
3. **Atomic swap**: :meth:`ModelGateway.swap_backend` commits the new
   backend under the registry's generation counter and waits
   for in-flight batches of the old generation to drain. Admission
   never closes and queues are untouched — zero dropped requests —
   and because the worker snapshots (backend, generation) per batch,
   no response ever mixes weights across versions: every
   :class:`~.gateway.GatewayResult` carries exactly one generation.

After a drained swap the old backend is unreferenced: its weights and
per-bucket signatures are released with it.
"""
from __future__ import annotations

from .. import log as _log
from ..telemetry import trace as _trace

__all__ = ["hot_swap"]

_logger = _log.get_logger("mxnet_tpu_torch.serving")


def hot_swap(gateway, name, *, params=None, checkpoint=None, epoch=None,
             manager=None, step=None, extract=None, warmup=True,
             drain_timeout=None):
    """Swap model ``name`` to a new version with zero dropped requests.

    Exactly one weight source:

    - ``params=`` — new positional params for an fn model;
    - ``checkpoint=`` (+ ``epoch=``) — a new ``model.save_checkpoint``
      artifact for a checkpoint model (``checkpoint=True`` reuses the
      spec's prefix with the new ``epoch``);
    - ``manager=`` (+ ``step=``, ``extract=``) — restore a training
      job's committed checkpoint through
      :class:`~..checkpoint.CheckpointManager` and map its state to
      serving params with ``extract(state) -> params``.

    Returns the new generation. ``warmup=False`` skips the off-path
    ladder warmup (the first request of each bucket then pays the new
    signature's first-call cost).
    """
    spec = gateway.registry.spec(name)
    with _trace.span("serving::swap", model=name):
        if manager is not None:
            if params is not None or checkpoint is not None:
                raise ValueError("pass manager= OR explicit weights, "
                                 "not both")
            if extract is None:
                raise ValueError(
                    "manager= needs extract=: a callable mapping the "
                    "restored training state_dict to the spec's serving "
                    "params")
            restored_step, state = manager.restore(step)
            params = extract(state)
            _trace.instant("serving::swap_restore", model=name,
                           step=restored_step)
        if checkpoint is True:
            checkpoint = spec.checkpoint
        backend = spec.build_backend(params=params, checkpoint=checkpoint,
                                     epoch=epoch)
        warmed = ()
        if warmup:
            # The gateway's own warmup seam: same ladder, same device
            # placement the serving path uses — a warmup on another
            # device would push the first-signature cost onto the first
            # post-swap request.
            with _trace.span("serving::swap_warmup", model=name):
                warmed = gateway.warm_backend(spec, backend)
        generation, drained = gateway.swap_backend(
            name, backend, warmed=warmed, drain_timeout=drain_timeout)
        if not drained:
            _log.warn_rate_limited(
                _logger, "gw_swap_drain:%s" % name, 60.0,
                "hot swap of model %r committed generation %d but an "
                "old-generation batch is still in flight past the drain "
                "timeout — old backend not yet released", name,
                generation)
    return generation
