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
"""
from __future__ import annotations

from .. import autograd
from .. import ndarray as nd
from ..cached_op import CachedOp
from ..ndarray.ndarray import NDArray
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        override, tracing_overrides)

__all__ = ["Block", "HybridBlock"]


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
        if self._cached_op is None:
            self._build_cache(*args)
        ctx = next((a.context for a in args if isinstance(a, NDArray)), None)
        param_data = [p.data(ctx) for p in self._cached_op_params]
        out = self._cached_op(*(param_data + list(args)))
        for p, v in self._cached_aux.pop(autograd.is_training(), {}).items():
            p.set_data(v)
        return out

    def __call__(self, *args, **kwargs):
        if self._active and tracing_overrides() is None and not kwargs:
            return self._call_cached_op(*args)
        return super().__call__(*args, **kwargs)
