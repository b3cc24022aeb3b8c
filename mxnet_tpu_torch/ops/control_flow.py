"""Control-flow operators: ``_foreach``, ``_while_loop`` and ``_cond``.

Counterpart of ``mxnet_tpu/ops/control_flow.py:68-169`` (reference
src/operator/control_flow.cc:476-539). The ``body``/``cond``/``func``/
``pred``/``then_g``/``else_g`` attrs are callables ``(explicit_inputs,
captured) -> [outputs]``: a :class:`SymSubgraph` on the symbolic path
(``sym.contrib``), whose graph runs the Executor's plan
(``executor._compile``, compiled once per training mode, then reused at
every iteration); a Python closure elsewhere. The JAX package lowers the
loops to ``lax.scan``/``lax.cond``; here they are Python loops over
eager torch ops, and torch's autograd records each iteration for the
gradient.

``_while_loop`` returns what the JAX op returns: the step outputs padded
to ``max_iterations`` rows with zeros past the executed steps, the final
loop variables, then the per-step validity mask (bool). It stops running
the body at the first false predicate (the JAX op runs all
``max_iterations`` steps masked; the values are the same).

A predicate is read on the host (:data:`PREDICATE_READS` counts the
reads): on the card that read waits for the stream.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["SymSubgraph", "PREDICATE_READS", "read_predicate"]

# Host reads of a loop or branch predicate since import (each one waits
# for the device when the predicate lives on the card).
PREDICATE_READS = [0]


def read_predicate(tensor):
    """The truth of a one-element predicate, read on the host."""
    PREDICATE_READS[0] += 1
    return bool(tensor.reshape(()).item())


class SymSubgraph:
    """A symbol sub-graph as a callable for the control-flow ops.

    `arg_names` are the placeholder variables fed per call (data slices,
    states, loop variables); `captured_names` are the enclosing graph's
    values cut into explicit op inputs (the reference's subgraph cut of
    free variables). The graph is compiled into the Executor's plan once
    per training mode.
    """

    def __init__(self, arg_names, captured_names, out_syms):
        self.arg_names = list(arg_names)
        self.captured_names = list(captured_names)
        self.out_syms = list(out_syms)
        self._plans = {}

    def __repr__(self):
        # The node attr's JSON form: opaque, and the same in every run.
        return "SymSubgraph(args=%s, captured=%s, outputs=%d)" % (
            self.arg_names, self.captured_names, len(self.out_syms))

    def plan(self, training):
        from ..executor import _compile

        got = self._plans.get(training)
        if got is None:
            got = self._plans[training] = _compile(self.out_syms, training)
        return got

    def __call__(self, args, captured):
        from .. import autograd
        from ..executor import _execute

        env = dict(zip(self.arg_names, args))
        env.update(zip(self.captured_names, captured))
        return _execute(self.plan(autograd.is_training()), env)[0]


def _shapes_only(tensors):
    """Shape inference runs the op on ``meta`` tensors: no predicate can
    be read there, so one step stands for the loop."""
    return any(t.device.type == "meta" for t in tensors)


def _stack_steps(steps, n, probe):
    """Outputs stacked over the steps (probe: one step's outputs, for
    the shapes when no step ran)."""
    if steps:
        return [torch.stack([s[i] for s in steps]) for i in range(n)]
    return [o.new_zeros((0,) + tuple(o.shape)) for o in probe]


@register("_foreach", num_inputs=None)
def _foreach(*arrays, body=None, n_data=1, n_states=0):
    """Scan `body` over axis 0 of the data arrays: body(data slices +
    states, captured) -> step outputs + new states. Returns the outputs
    stacked along axis 0, then the final states."""
    data = arrays[:n_data]
    states = list(arrays[n_data:n_data + n_states])
    captured = list(arrays[n_data + n_states:])
    steps = []
    for t in range(data[0].shape[0]):
        res = list(body([d[t] for d in data] + states, captured))
        steps.append(res[:len(res) - n_states])
        states = res[len(res) - n_states:]
    probe = None
    if not steps:
        with torch.no_grad():
            res = body([d.new_zeros(d.shape[1:]) for d in data] + states,
                       captured)
        probe = res[:len(res) - n_states]
    n_outs = len(steps[0]) if steps else len(probe)
    return tuple(_stack_steps(steps, n_outs, probe)) + tuple(states)


@register("_while_loop", num_inputs=None)
def _while_loop(*arrays, cond=None, func=None, n_vars=1,
                max_iterations=None):
    """Run func(loop_vars, captured) -> step outputs + new loop vars
    while cond(loop_vars, captured) holds, at most `max_iterations`
    times. Returns the outputs padded to `max_iterations` rows, the final
    loop vars and the validity mask."""
    limit = int(max_iterations)
    loop_vars = list(arrays[:n_vars])
    captured = list(arrays[n_vars:])
    steps = []
    while len(steps) < limit and not _shapes_only(loop_vars) \
            and read_predicate(cond(loop_vars, captured)[0]):
        res = list(func(loop_vars, captured))
        steps.append(res[:len(res) - n_vars])
        loop_vars = res[len(res) - n_vars:]
    probe = None
    if not steps:
        with torch.no_grad():
            res = func(loop_vars, captured)
        probe = res[:len(res) - n_vars]
    n_outs = len(steps[0]) if steps else len(probe)
    outs = []
    for o in _stack_steps(steps, n_outs, probe):
        pad = o.new_zeros((limit - o.shape[0],) + tuple(o.shape[1:]))
        outs.append(torch.cat([o, pad]) if pad.shape[0] else o)
    device = loop_vars[0].device
    valid = torch.arange(limit, device=device) < len(steps)
    return tuple(outs) + tuple(loop_vars) + (valid,)


@register("_cond", num_inputs=None)
def _cond(*arrays, pred=None, then_g=None, else_g=None):
    """then_g or else_g on `arrays`, whichever pred(arrays) selects; all
    three take ([], captured), every input being a captured value."""
    captured = list(arrays)
    if _shapes_only(captured) or read_predicate(pred([], captured)[0]):
        return tuple(then_g([], captured))
    return tuple(else_g([], captured))
