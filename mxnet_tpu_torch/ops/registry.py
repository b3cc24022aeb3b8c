"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` (reference: the NNVM op
registry). An operator's FCompute is a plain function of torch tensors
and keyword attrs, ``fn(*tensors, **attrs) -> tensor | tuple``. Dispatch
runs it eagerly on the device its inputs live on: there is no jit cache
and no traced-inline branch, because PyTorch has no trace to inline
into.

RNG operators (``needs_rng=True``, Dropout and RNN) take a keyword
``generator``: dispatch passes the ``torch.Generator`` of the device the
first input lives on (:func:`mxnet_tpu_torch.random.for_device`), where
the JAX package prepends a fresh PRNG key.
"""
from __future__ import annotations

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
    needs_rng : dispatch passes ``generator=``, the inputs' device's.
    """

    def __init__(self, name: str, fn: Callable, *, differentiable=True,
                 num_inputs=None, aliases=(), train_aware=False,
                 needs_rng=False):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.num_inputs = num_inputs
        self.aliases = tuple(aliases)
        self.train_aware = train_aware
        self.needs_rng = needs_rng

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name, *, differentiable=True, num_inputs=None, aliases=(),
             train_aware=False, needs_rng=False):
    """Decorator: register a torch FCompute under `name`."""

    def deco(fn):
        op = Operator(name, fn, differentiable=differentiable,
                      num_inputs=num_inputs, aliases=aliases,
                      train_aware=train_aware, needs_rng=needs_rng)
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


def rng_attrs(tensors):
    """``{"generator": ...}`` for an RNG op on `tensors`: the generator of
    the first tensor's device (none on ``meta``, where shapes are
    inferred and nothing is drawn)."""
    from .. import random as _random

    device = next(t.device for t in tensors if hasattr(t, "device"))
    if device.type == "meta":
        return {"generator": None}
    return {"generator": _random.for_device(device)}


def invoke_raw(op: Operator, tensors, attrs, named=()):
    """Run `op` on torch tensors. Trailing `named` entries of `tensors`
    are bound by keyword."""
    DISPATCHES[0] += 1
    if op.needs_rng and "generator" not in attrs:
        attrs = dict(attrs, **rng_attrs(tensors))
    if named:
        n = len(tensors) - len(named)
        kw = dict(zip(named, tensors[n:]))
        return op.fn(*tensors[:n], **kw, **attrs)
    return op.fn(*tensors, **attrs)
