"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``. Blocks hold their
parameters as NDArrays over torch tensors and keep the JAX package's
naming: a block without an explicit prefix takes ``<class name><n>_``
from a process-wide counter per class name, so parameter names come out
as in the reference.

``hybridize()`` routes calls through a :class:`CachedOp`: parameters
are passed as its leading inputs and reach the layers through
``parameter.override``, and aux-state writes (BatchNorm running stats in
train mode) are captured and committed after the call, exactly as in
the JAX package. Deferred initialization: layers implement
``infer_shape(*args)``, which fills parameter shapes from the first
input.

Symbolic re-trace: called on a :class:`~mxnet_tpu_torch.symbol.Symbol`,
a block's parameters become named variables and ``hybrid_forward`` runs
with ``F = symbol``. ``export`` writes that graph and the weights in the
reference's checkpoint format; :class:`SymbolBlock` (``imports``) runs
such a checkpoint through the Executor's plan.
"""
from __future__ import annotations

import contextlib

import torch

from .. import autograd
from .. import ndarray as nd
from .. import symbol as _sym
from ..cached_op import CachedOp
from ..ndarray.ndarray import NDArray
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        override, tracing_overrides)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name scoping for parameter prefixes."""

    _counters: dict = {}

    @staticmethod
    def create(prefix, params, hint):
        if prefix is None:
            cnt = _BlockScope._counters.get(hint, 0)
            _BlockScope._counters[hint] = cnt + 1
            prefix = "%s%d_" % (hint, cnt)
        if params is None:
            params = ParameterDict(prefix)
        else:
            # Donor-prefix semantics: names resolve under the donor
            # dict's prefix, so its parameters are shared by name.
            params = ParameterDict(params.prefix, shared=params)
        return prefix, params


class Block:
    """Base building block (reference: gluon/block.py:Block)."""

    def __init__(self, prefix=None, params=None):
        hint = self._alias()
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._children = {}
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        """A null context, as in the JAX package: children are named by
        the per-class counters whether or not they are made inside it."""
        return contextlib.nullcontext()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def collect_params(self):
        """All parameters of self and its descendants."""
        out = ParameterDict(self._params.prefix)
        seen = set()

        def visit(block):
            if id(block) in seen:
                return
            seen.add(id(block))
            for name, p in block._params.items():
                out._params[name] = p
            for child in block._children.values():
                visit(child)

        visit(self)
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter to `dtype` (reference block.py:cast; the
        JAX package's ``Block.cast`` casts BatchNorm's too)."""
        for p in self.collect_params().values():
            p.cast(dtype)

    def _collect_params_with_prefix(self, prefix=""):
        """{attribute path: Parameter}, e.g. ``"0.weight"``: the names
        of ``save_parameters`` files, portable across prefixes."""
        ret = {}
        for name, p in self._reg_params.items():
            ret[prefix + name] = p
        for cname, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + cname + "."))
        return ret

    def save_parameters(self, filename):
        """Structured param file (reference: block.py:save_parameters —
        flat attribute-path names). The JAX package's bytes for the same
        weights: bfloat16 is written as float32, as ``nd.save`` does."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {name: p.data() for name, p in params.items()
                           if p._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Load a :meth:`save_parameters` file of either package.
        ``cast_dtype`` casts each loaded array to its parameter's dtype
        (a bfloat16 net loads the float32 words of a file); without it
        the loaded dtype is installed, as in the JAX package."""
        from ..context import cpu

        loaded = nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not isinstance(loaded, dict):
            raise ValueError("%s is not a parameter file" % filename)
        for name, p in params.items():
            if name in loaded:
                value = loaded[name]
                if p.shape is None or p._data is None:
                    p.shape = value.shape
                    p.initialize(ctx=ctx)
                if cast_dtype:
                    value = value.astype(p.data()._data.dtype)
                p.set_data(value)
            elif not allow_missing:
                raise ValueError("Parameter %s missing in %s"
                                 % (name, filename))
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise ValueError("Extra parameters in %s: %s"
                                 % (filename, extra))

    # legacy aliases (the reference keeps both save_params/save_parameters)
    def save_params(self, filename):
        self.save_parameters(filename)

    def load_params(self, filename, ctx=None, **kwargs):
        self.load_parameters(filename, ctx=ctx, **kwargs)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block whose calls can go through one CachedOp (reference:
    gluon/block.py:HybridBlock — hybrid_forward(F, x, **params))."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._cached_op_params = None
        self._cached_aux = {}
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = kwargs
        self._cached_op = None
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Fill deferred parameter shapes from input shapes. Layers with
        deferred params override this; composite blocks infer through
        their children during forward."""

    def _ensure_init(self, *args):
        # Use the replica on the input's device.
        ctx = next((a.context for a in args if isinstance(a, NDArray)), None)
        try:
            return {k: p.data(ctx) for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init(p.shape)
            return {k: p.data(ctx) for k, p in self._reg_params.items()}

    def forward(self, x, *args):
        if isinstance(x, _sym.Symbol):
            # Symbolic re-trace (export): parameters become variables
            # named like the parameters. Aux-ness (BatchNorm's moving
            # stats) comes from the op composition, not from grad_req.
            params = {k: _sym.Symbol(None, name=p.name)
                      for k, p in self._reg_params.items()}
            return self.hybrid_forward(_sym, x, *args, **params)
        self._num_forward_inputs = 1 + len(args)
        params = self._ensure_init(x, *args)
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _build_cache(self, *args):
        params = list(self.collect_params().values())
        if any(p._data is None and p._deferred_init is not None
               for p in params):
            # Shape discovery: one plain pass; an empty override scope
            # keeps children off their own cached ops and captures (drops)
            # aux writes.
            with autograd.pause(), override({}):
                self.forward(*args)
        params = [p for p in self.collect_params().values()
                  if p._data is not None]
        self._cached_op_params = params
        n = len(params)
        block = self

        def fn(*xs):
            ov = override(dict(zip(params, xs[:n])))
            with ov:
                out = block.forward(*xs[n:])
            # Aux bookkeeping per train mode: only train mode writes
            # BatchNorm running stats.
            block._cached_aux[autograd.is_training()] = ov.writes
            return out

        self._cached_op = CachedOp(fn, num_params=n, **self._flags)

    def _call_cached_op(self, *args):
        # export() needs the call's arity; a hybridized block may never
        # run the plain forward that records it.
        self._num_forward_inputs = len(args)
        if self._cached_op is None:
            self._build_cache(*args)
        ctx = next((a.context for a in args if isinstance(a, NDArray)), None)
        param_data = [p.data(ctx) for p in self._cached_op_params]
        out = self._cached_op(*(param_data + list(args)))
        for p, v in self._cached_aux.pop(autograd.is_training(), {}).items():
            p.set_data(v)
        return out

    def __call__(self, *args, **kwargs):
        if self._active and tracing_overrides() is None and not kwargs \
                and not any(isinstance(a, _sym.Symbol) for a in args):
            return self._call_cached_op(*args)
        return super().__call__(*args, **kwargs)

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (reference
        block.py:export): the block is re-traced through the Symbol
        frontend in inference mode, and the weights are saved under the
        reference's ``arg:``/``aux:`` keys, so ``SymbolBlock.imports``,
        ``InferenceServer.from_checkpoint``, the JAX package and the
        reference load the pair. Call the block once first, so that its
        parameters are initialized. Returns (symbol_file, params_file)."""
        n_in = getattr(self, "_num_forward_inputs", 1)
        names = ["data"] if n_in == 1 else \
            ["data%d" % i for i in range(n_in)]
        with autograd.pause(train_mode=False):
            out = self(*[_sym.var(n) for n in names])
        if isinstance(out, (list, tuple)):
            out = _sym.Group(list(out))
        sym_file = "%s-symbol.json" % path
        out.save(sym_file)
        arg_names = set(out.list_arguments())
        aux_names = set(out.list_auxiliary_states())
        save_dict = {}
        for p in self.collect_params().values():
            if p._data is None:
                continue
            if p.name in aux_names:
                save_dict["aux:%s" % p.name] = p.data()
            elif p.name in arg_names:
                save_dict["arg:%s" % p.name] = p.data()
        params_file = "%s-%04d.params" % (path, epoch)
        nd.save(params_file, save_dict)
        return sym_file, params_file

    def export_stablehlo(self, path, *example_inputs):
        """The JAX package serializes its jitted computation as StableHLO
        through ``jax.export``; PyTorch on an NVIDIA card has no such
        artifact here. Use :meth:`export` (symbol + params)."""
        raise NotImplementedError(
            "export_stablehlo has no counterpart on the PyTorch/CUDA port; "
            "use HybridBlock.export (prefix-symbol.json + prefix-%04d.params)")


class SymbolBlock(HybridBlock):
    """A block over a symbol graph (reference block.py:SymbolBlock).
    The forward runs the Executor's plan (``executor._compile``, one per
    training mode) on the block's parameters, under
    ``autograd.record()`` too, so an imported model trains like any
    block; in training, BatchNorm's new moving statistics go to the aux
    parameters (through ``set_data``, which a hybridized call captures
    and commits after the call)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(list(outputs))
        self._outputs = outputs
        self._inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._plans = {}
        input_names = {i.name for i in self._inputs}
        params = params or {}
        aux_set = set(outputs.list_auxiliary_states())
        for name in list(outputs.list_arguments()) + sorted(aux_set):
            if name in input_names:
                continue
            p = params.get(name)
            if isinstance(p, Parameter):
                self._params._params[name] = p
                continue
            newp = self._params.get(
                name, allow_deferred_init=True,
                grad_req="null" if name in aux_set else "write")
            if p is not None:  # an NDArray or numpy array
                newp.shape = tuple(p.shape)
                newp.initialize(init="zeros", ctx=p.context
                                if isinstance(p, NDArray) else None)
                newp.set_data(p)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """Reload an exported model (reference SymbolBlock.imports):
        ``arg:``/``aux:``-prefixed or plain parameter names. The weights
        land on `ctx` (default: the current context)."""
        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [_sym.var(n) for n in input_names]
        params = {}
        if param_file:
            for k, v in nd.load(param_file, ctx=ctx).items():
                name = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) \
                    else k
                params[name] = v
            # A truncated checkpoint fails here, with the missing names.
            missing = [n for n in (list(sym.list_arguments())
                                   + list(sym.list_auxiliary_states()))
                       if n not in input_names and n not in params]
            if missing:
                raise ValueError(
                    "Parameter file %s is missing graph parameters %s"
                    % (param_file, sorted(missing)))
        return SymbolBlock(sym, inputs, params=params)

    def _plan(self, training, graph):
        """The plan per (training mode, building a graph). A forward that
        builds no graph binds the graph as ``Symbol.bind`` would, so
        ``MXNET_SUBGRAPH_BACKEND`` partitions it there."""
        from ..executor import _auto_partition, _compile

        key = (training, graph)
        plan = self._plans.get(key)
        if plan is None:
            sym = self._outputs if graph else _auto_partition(self._outputs)
            plan = self._plans[key] = _compile(sym.outputs, training)
        return plan

    def forward(self, *args):
        from ..executor import _execute

        data = {inp.name: val if isinstance(val, NDArray) else nd.array(val)
                for inp, val in zip(self._inputs, args)}
        ctx = next(iter(data.values())).context if data else None
        training = autograd.is_training()
        graph = autograd.builds_graph()
        if graph and autograd.is_recording():
            for v in data.values():
                autograd._make_leaf(v)
        plan = self._plan(training, graph)
        env = {n: data[n]._data if n in data
               else self._params[n].data(ctx)._data
               for _, n in plan[0]}
        with torch.set_grad_enabled(graph):
            outs, aux_writes = _execute(plan, env)
        if training:
            for n, v in aux_writes.items():
                if n in self._params:
                    self._params[n].set_data(NDArray(v.detach(), ctx=ctx))
        outs = [NDArray(o, ctx=ctx) for o in outs]
        for o in outs:
            o._recorded = graph
        return outs[0] if len(outs) == 1 else outs
