"""Executor — the static-graph runtime.

Counterpart of ``mxnet_tpu/executor.py`` (reference
include/mxnet/executor.h, src/executor/graph_executor.cc). The JAX
package compiles a bound graph into one XLA executable and takes
``jax.vjp`` of it for the backward. The port runs the graph eagerly,
node by node, on torch tensors: there is no jit and no compile cache.
The backward is torch.autograd over the recorded forward: a
``forward(is_train=True)`` with gradients requested records the graph
from leaves of the arguments that want a gradient, and ``backward``
differentiates it, freeing the saved activations as it goes. After an
eval-mode forward, or a second ``backward`` of one forward, ``backward``
records a train-mode forward first, as the JAX package's vjp re-runs the
forward in train mode.

``forward`` writes fed values into the bound argument arrays in place;
BatchNorm's train-mode moving statistics go to the aux arrays.
``_subgraph`` nodes (``subgraph.partition``) run their backend function
or, when it is None, their embedded sub-DAG. The graph is flattened
once per executor and mode into a plan of numbered value slots, so a
forward costs one Python call per node. That plan (:func:`_compile`,
:func:`_execute`) is the port's one graph interpreter: ``SymbolBlock``
runs it on its parameters' tensors, under ``autograd.record()`` too,
and the control-flow operators run their sub-graphs through it
(``ops/control_flow.SymSubgraph``). With
``MXNET_SUBGRAPH_BACKEND`` naming a registered backend, the graph is
partitioned at bind, as in the JAX package and the reference.

``group2ctx`` is accepted only where every group maps to the executor's
own device: model-parallel placement across devices is ROADMAP Queue
1 item 7b.
"""
from __future__ import annotations

import logging
import os

import torch

from .base import MXNetError
from . import autograd
from .context import Context, current_context
from .ndarray.ndarray import NDArray, array as nd_array
from .ops import registry as _registry

__all__ = ["Executor"]


def _auto_partition(symbol):
    """Partition at bind when MXNET_SUBGRAPH_BACKEND names a registered
    backend; an unknown name warns and binds unpartitioned (reference
    build_subgraph pass; executor.py:45-61 of the JAX package)."""
    backend = os.environ.get("MXNET_SUBGRAPH_BACKEND", "")
    if not backend:
        return symbol
    from . import subgraph as _subgraph

    if backend in _subgraph.list_backends():
        return _subgraph.partition(symbol, backend)
    logging.warning(
        "MXNET_SUBGRAPH_BACKEND=%r is not a registered subgraph backend "
        "(registered: %s); binding without partitioning", backend,
        _subgraph.list_backends())
    return symbol


class Executor:
    """(reference executor.py:Executor)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 shared_exec=None):
        symbol = _auto_partition(symbol)
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self._check_group2ctx(symbol, group2ctx)

        if isinstance(args, dict):
            self.arg_arrays = [args[n] for n in self.arg_names]
        else:
            self.arg_arrays = list(args or [])
        if len(self.arg_arrays) != len(self.arg_names):
            raise MXNetError("bind: expected %d args (%s), got %d"
                             % (len(self.arg_names), self.arg_names,
                                len(self.arg_arrays)))
        self.arg_arrays = [a if isinstance(a, NDArray)
                           else nd_array(a, ctx=self._ctx)
                           for a in self.arg_arrays]

        if isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in self.arg_names]
        elif args_grad is None:
            self.grad_arrays = [None] * len(self.arg_names)
        else:
            self.grad_arrays = list(args_grad)

        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req or {})

        if isinstance(aux_states, dict):
            self.aux_arrays = [aux_states[n] for n in self.aux_names]
        else:
            self.aux_arrays = list(aux_states or [])
        if len(self.aux_arrays) != len(self.aux_names):
            if self.aux_arrays or not self.aux_names:
                raise MXNetError("bind: expected %d aux states, got %d"
                                 % (len(self.aux_names),
                                    len(self.aux_arrays)))
            # allocate the aux states from the inferred shapes
            from . import ndarray as nd

            shapes = {n: a.shape for n, a in
                      zip(self.arg_names, self.arg_arrays)}
            _, _, aux_shapes = symbol.infer_shape(**shapes)
            self.aux_arrays = [nd.zeros(s, ctx=self._ctx)
                               for s in aux_shapes]
        self.aux_arrays = [a if isinstance(a, NDArray)
                           else nd_array(a, ctx=self._ctx)
                           for a in self.aux_arrays]

        self.outputs = []
        self.num_forwards = 0
        self._monitor_callback = None
        self._recorded = None  # (leaves by name, output tensors)
        self._last_train = None
        self._plans = {}  # is_train -> compiled evaluation plan

    def _check_group2ctx(self, symbol, group2ctx):
        if not group2ctx:
            return
        used = {n._attrs.get("__ctx_group__") for n in symbol._topo()
                if n._attrs.get("__ctx_group__") is not None}
        unknown = used - set(group2ctx)
        if unknown:
            raise MXNetError("bind: symbol uses ctx_group(s) %s with no "
                             "entry in group2ctx %s"
                             % (sorted(unknown), sorted(group2ctx)))
        elsewhere = {g: c for g, c in group2ctx.items()
                     if Context(c) != self._ctx}
        if elsewhere:
            raise NotImplementedError(
                "group2ctx places groups %s on devices other than the "
                "executor's %s: model-parallel placement is not ported yet "
                "(ROADMAP Queue 1 item 7b)" % (sorted(elsewhere), self._ctx))

    # -- graph evaluation -----------------------------------------------------

    def _plan(self, training):
        plan = self._plans.get(training)
        if plan is None:
            plan = self._plans[training] = _compile(self._symbol.outputs,
                                                    training)
        return plan

    def _grad_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"]

    def _run(self, is_train, record):
        """One forward. With `record`, the arguments that want a gradient
        enter as leaves and the graph is kept for backward."""
        env = {n: a._data for n, a in zip(self.arg_names, self.arg_arrays)}
        env.update((n, a._data) for n, a in
                   zip(self.aux_names, self.aux_arrays))
        leaves = {}
        if record:
            env = {n: t.detach() for n, t in env.items()}
            for n in self._grad_names():
                if env[n].is_floating_point():
                    leaves[n] = env[n] = env[n].requires_grad_(True)
        with autograd.pause(train_mode=is_train), \
                torch.set_grad_enabled(record):
            outs, aux_writes = _execute(self._plan(bool(is_train)), env)
        return outs, aux_writes, leaves

    def forward(self, is_train=False, **kwargs):
        """(reference executor.py:forward → GraphExecutor::Forward)."""
        for name, val in kwargs.items():
            if name not in self.arg_names:
                raise MXNetError("unknown argument %r" % name)
            self.arg_arrays[self.arg_names.index(name)][:] = val
        record = bool(is_train) and bool(self._grad_names())
        # Drop the previous forward's graph first: kept, it would hold a
        # second set of activations through this forward (Module.fit
        # calls forward/backward on one executor every batch).
        self._recorded = None
        outs, aux_writes, leaves = self._run(is_train, record)
        for n, arr in zip(self.aux_names, self.aux_arrays):
            new = aux_writes.get(n)
            if new is not None and new is not arr._data:
                arr._set_data(new.detach())
        self._recorded = (leaves, outs) if record else None
        self._last_train = bool(is_train)
        self.num_forwards += 1
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self.output_names, self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """(reference executor.py:backward → GraphExecutor::Backward).
        Loss heads (SoftmaxOutput) define their own gradient, so a call
        without out_grads matches the reference."""
        if self._last_train is None:
            raise MXNetError("backward called before forward")
        grad_names = self._grad_names()
        if not grad_names:
            return
        if self._recorded is None:
            # The last forward ran in eval mode, recorded nothing, or its
            # graph was spent by an earlier backward: record a train-mode
            # forward; its aux writes are dropped, as the JAX package's
            # vjp drops them.
            outs, _, leaves = self._run(True, True)
        else:
            leaves, outs = self._recorded
            # The graph is spent here: backward frees its saved
            # activations as it goes, as loss.backward() does, instead
            # of holding them all to its end.
            self._recorded = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [g._data if isinstance(g, NDArray)
                     else torch.as_tensor(g, device=o.device)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h.to(o.dtype)) for o, h in zip(outs, heads)
                 if o.requires_grad]
        names = [n for n in grad_names if n in leaves]
        got = [None] * len(names)
        if pairs and names:
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [leaves[n] for n in names],
                                      [h for _, h in pairs],
                                      allow_unused=True)
        grads = dict(zip(names, got))
        for i, n in enumerate(self.arg_names):
            req = self.grad_req.get(n, "null")
            if req == "null":
                continue
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(self.arg_arrays[i]._data)
            target = self.grad_arrays[i]
            if target is None:
                self.grad_arrays[i] = NDArray(g.detach(), ctx=self._ctx)
            elif req == "add":
                target._set_data(target._data + g.detach())
            else:  # write
                target._set_data(g.detach().to(target._data.dtype))

    # -- utilities ------------------------------------------------------------

    @property
    def arg_dict(self):
        return dict(zip(self.arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self.arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self.aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """(reference executor.py:copy_params_from)."""
        arg_dict, aux_dict = self.arg_dict, self.aux_dict
        for name, array in arg_params.items():
            if name in arg_dict:
                arg_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in aux_dict:
                aux_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "auxiliary states" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes, sharing the arrays whose
        shape is unchanged (reference GraphExecutor::Reshape, the
        bucketing mechanism)."""
        from . import ndarray as nd

        shapes = {n: a.shape for n, a in
                  zip(self.arg_names, self.arg_arrays)}
        shapes.update({k: tuple(v) for k, v in kwargs.items()})
        arg_shapes, _, _ = self._symbol.infer_shape(**shapes)
        new_args = [a if a.shape == tuple(s) else nd.zeros(s, ctx=self._ctx)
                    for a, s in zip(self.arg_arrays, arg_shapes)]
        new_grads = None
        if any(g is not None for g in self.grad_arrays):
            new_grads = [None if g is None else
                         g if g.shape == tuple(s) else
                         nd.zeros(s, ctx=self._ctx)
                         for g, s in zip(self.grad_arrays, arg_shapes)]
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self.grad_req, self.aux_arrays)

    def set_monitor_callback(self, callback, monitor_all=False):
        """(reference MXExecutorSetMonitorCallback)."""
        self._monitor_callback = callback

    def debug_str(self):
        lines = ["Symbol outputs: %s" % self.output_names]
        for n in self._symbol._topo():
            if n._op:
                lines.append("%s(%s)" % (n._op, n._name))
        return "\n".join(lines)


def _topo(out_syms):
    seen, order = set(), []

    def visit(node):
        if node._uid in seen:
            return
        seen.add(node._uid)
        for i in node._inputs:
            visit(i)
        order.append(node)

    for s in out_syms:
        visit(s)
    return [n for n in order if n._op != "_group"]


def _compile(out_syms, training):
    """The DAG as a flat plan, built once per executor and mode: values
    live in numbered slots; each step is (fn, input slots, attrs, output
    slots, aux names, fragment, the operator when dispatch owes it a
    ``device=`` or ``generator=`` keyword, slots to free), run by
    :func:`_execute`.
    A value's slot is freed after its last consumer (or at once, when it
    has none and is not an output), so a forward holds no more than the
    values still to be read and what autograd saved for the backward.
    Train-aware ops get ``training`` in their attrs, as the JAX package
    injects the current mode (executor.py:204-205 there)."""
    slots = {}

    def slot(node, index):
        return slots.setdefault((node._uid, index or 0), len(slots))

    variables, steps = [], []
    for node in _topo(out_syms):
        if node._op is None:
            variables.append((slot(node, 0), node._name))
            continue
        ins = [slot(i, i._out_index) for i in node._inputs]
        outs = [slot(node, k) for k in range(node._num_outputs)]
        if node._op == "_subgraph":
            fn = getattr(node, "_sub_fn", None)
            if fn is None:
                fn = _subdag_fn(node, training)
            steps.append((fn, ins, {}, outs, (), node, None))
            continue
        op = _registry.get(node._attrs.get("_op_name", node._op))
        attrs = node._clean_attrs()
        aux = ()
        if op.train_aware:
            attrs["training"] = training
            # Only a train-aware op (BatchNorm) returns new aux values.
            aux = tuple(i._name for i in node._inputs
                        if i._op is None and i._is_aux)
        steps.append((op.fn, ins, attrs, outs, aux, None,
                      op if op.needs_rng or op.creates else None))
    heads = [slot(s, s._out_index) for s in out_syms]
    last = {}
    for k, step in enumerate(steps):
        for i in list(step[1]) + list(step[3]):
            last[i] = k
    frees = [[] for _ in steps]
    for i, k in last.items():
        if i not in heads:
            frees[k].append(i)
    steps = [step + (tuple(free),) for step, free in zip(steps, frees)]
    return variables, steps, heads, len(slots)


def _subdag_fn(node, training):
    """A fragment without a backend function evaluates its sub-DAG."""
    plan = _compile(node._sub_sym.outputs, training)
    names = list(node._sub_arg_names)

    def run(*values):
        return _execute(plan, dict(zip(names, values)))[0]

    return run


def _execute(plan, env):
    """Run a plan on the tensors of `env` (variable name -> tensor).
    Returns (output tensors, aux writes): BatchNorm returns (out,
    new_mean, new_var), and the new statistics go to its aux inputs
    (reference: the op mutates its aux states). An op that makes a
    tensor from attrs alone makes it on the device of the first tensor
    of `env`, else on the current context's."""
    device = next((v.device for v in env.values()
                   if isinstance(v, torch.Tensor)), None)
    variables, steps, heads, n = plan
    vals = [None] * n
    for s, name in variables:
        vals[s] = env[name]
    aux_writes = {}
    ops = 0
    for fn, ins, attrs, outs, aux, fragment, keyed, free in steps:
        args = [vals[i] for i in ins]
        if keyed is not None:
            if device is None and keyed.creates:
                device = current_context().torch_device
            attrs = _registry.device_attrs(keyed, args, attrs, device)
        raw = fn(*args, **attrs)
        if fragment is not None:
            got = raw if isinstance(raw, (list, tuple)) else [raw]
            if len(got) < fragment._num_outputs:
                raise ValueError(
                    "_subgraph %r: backend fn returned %d value(s) for a "
                    "%d-output fragment — a consumer of the missing output "
                    "would silently read the wrong value"
                    % (fragment._name, len(got), fragment._num_outputs))
        elif isinstance(raw, (list, tuple)):
            ops += 1
            got = raw
            if aux and len(raw) == 1 + len(aux):
                aux_writes.update(zip(aux, raw[1:]))
                got = raw[:1]
        else:
            ops += 1
            got = (raw,)
        for s, v in zip(outs, got):
            vals[s] = v
        for s in free:
            vals[s] = None
    _registry.DISPATCHES[0] += ops
    return [vals[s] for s in heads], aux_writes
