"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` (reference: the NNVM op
registry). An operator's FCompute is a plain function of torch tensors
and keyword attrs, ``fn(*tensors, **attrs) -> tensor | tuple``. Dispatch
runs it eagerly on the device its inputs live on: there is no jit cache
and no traced-inline branch, because PyTorch has no trace to inline
into.

RNG operators (``needs_rng=True``: Dropout, RNN and the samplers of
``random_ops``) take a keyword ``generator``: dispatch passes the
``torch.Generator`` of the device the op runs on
(:func:`mxnet_tpu_torch.random.for_device`), where the JAX package
prepends a fresh PRNG key.

Operators that make a tensor from attrs alone (``zeros``, ``arange``,
``_random_uniform``; ``creates=True``) take a keyword ``device``:
dispatch passes the device of the caller's context, where the JAX
package places the result on its default device.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["Operator", "register", "get", "list_all_ops", "invoke_raw",
           "rng_attrs", "OP_REGISTRY", "DISPATCHES"]

OP_REGISTRY: dict[str, "Operator"] = {}

# Operator dispatches since import (every invoke_raw call), as in the
# JAX package's counter of the same name.
DISPATCHES = [0]


class Operator:
    """A registered operator.

    Parameters
    ----------
    name : canonical op name (`mx.nd.<name>`).
    fn : function of torch tensors + keyword attrs.
    differentiable : whether the op has a gradient.
    num_inputs : fixed arity or None for variadic.
    aliases : extra registry names.
    train_aware : dispatch passes ``training=`` from the autograd mode.
    needs_rng : dispatch passes ``generator=``, the op's device's.
    creates : dispatch passes ``device=``, where the result is made.
    infer_shape : ``fn(attrs, input shapes, None where unknown) ->
        (input shapes, output shapes)``; ``Symbol.infer_shape`` takes it
        instead of running ``fn`` on ``meta`` tensors (``Custom``'s asks
        the user's ``CustomOpProp`` and never runs the user's forward).
    """

    def __init__(self, name: str, fn: Callable, *, differentiable=True,
                 num_inputs=None, aliases=(), train_aware=False,
                 needs_rng=False, creates=False, infer_shape=None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.num_inputs = num_inputs
        self.aliases = tuple(aliases)
        self.train_aware = train_aware
        self.needs_rng = needs_rng
        self.creates = creates
        self.infer_shape = infer_shape

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name, *, differentiable=True, num_inputs=None, aliases=(),
             train_aware=False, needs_rng=False, creates=False,
             infer_shape=None):
    """Decorator: register a torch FCompute under `name`."""

    def deco(fn):
        op = Operator(name, fn, differentiable=differentiable,
                      num_inputs=num_inputs, aliases=aliases,
                      train_aware=train_aware, needs_rng=needs_rng,
                      creates=creates, infer_shape=infer_shape)
        OP_REGISTRY[name] = op
        for a in aliases:
            OP_REGISTRY[a] = op
        return fn

    return deco


def get(name: str) -> Operator:
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise AttributeError("operator %r is not registered" % name) from None


def list_all_ops():
    return sorted(OP_REGISTRY)


def rng_attrs(tensors, device=None):
    """``{"generator": ...}`` for an RNG op on `tensors`: the generator of
    `device`, else of the first tensor's device (none on ``meta``, where
    shapes are inferred and nothing is drawn)."""
    from .. import random as _random

    if device is None:
        device = next(t.device for t in tensors if hasattr(t, "device"))
    if device.type == "meta":
        return {"generator": None}
    return {"generator": _random.for_device(device)}


def device_attrs(op, tensors, attrs, default):
    """`attrs` with the keywords dispatch owes `op`: ``device=`` for a
    creating op (the first tensor's device, else `default`, the caller's
    torch device), ``generator=`` for an RNG op."""
    if op.creates and "device" not in attrs:
        device = next((t.device for t in tensors if hasattr(t, "device")),
                      default)
        attrs = dict(attrs, device=device)
    if op.needs_rng and "generator" not in attrs:
        attrs = dict(attrs, **rng_attrs(tensors, attrs.get("device")))
    return attrs


_profiler_mod = None


def invoke_raw(op: Operator, tensors, attrs, named=(), device=None):
    """Run `op` on torch tensors. Trailing `named` entries of `tensors`
    are bound by keyword; `device` places a creating op that has no
    tensor input. While ``profiler`` runs, the call's host dispatch time
    goes to its per-op table (no synchronisation: on the card it is the
    enqueue)."""
    global _profiler_mod
    DISPATCHES[0] += 1
    if op.creates or op.needs_rng:
        attrs = device_attrs(op, tensors, attrs, device)
    if _profiler_mod is None:
        from .. import profiler as _profiler_mod_     # lazy, once

        _profiler_mod = _profiler_mod_
    if _profiler_mod.is_recording():
        # The reference's ExecuteOprBlock wraps each op in
        # ProfileOperator (threaded_engine.h:338-347).
        t0 = time.perf_counter()
        out = _call(op, tensors, attrs, named)
        _profiler_mod.record_op_span(op.name, time.perf_counter() - t0)
        return out
    return _call(op, tensors, attrs, named)


def _call(op, tensors, attrs, named):
    if named:
        n = len(tensors) - len(named)
        kw = dict(zip(named, tensors[n:]))
        return op.fn(*tensors[:n], **kw, **attrs)
    return op.fn(*tensors, **attrs)
