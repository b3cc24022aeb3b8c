"""Gluon Parameter / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``: parameters with
deferred shape inference, one NDArray per context, and ``override()``,
the thread-local scope in which ``Parameter.data()`` returns a mapped
array and ``set_data`` is captured instead of applied. The port's
CachedOp passes parameters to the hybridized forward through it, as the
JAX package does, and a served function uses it to run a net on other
copies of its weights (bfloat16 casts, for example).

Gradient buffers follow ``mxnet_tpu/gluon/parameter.py``: a parameter
whose ``grad_req`` is not ``"null"`` gets a zero buffer per context when
its data is allocated, and its data arrays are marked as autograd
variables, so ``autograd.backward`` writes (or, for ``"add"``,
accumulates) into ``grad()``. Setting ``grad_req = "null"`` drops the
buffer. BatchNorm's running statistics are ``"null"`` parameters, and
their train-mode writes are detached values.

What the Trainer reads, as in the JAX package: ``lr_mult``/``wd_mult``,
``list_ctx()``/``list_data()``, ``_grad_stype`` (always ``"default"``:
the port has no sparse NDArray, ROADMAP Queue 1 item 11) and
``cast(dtype)``, which re-types the data and the gradient buffers (the
way a net is trained in bfloat16).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype
from ..context import Context, current_context
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "ParameterDict",
           "DeferredInitializationError", "override", "tracing_overrides"]

_tls = threading.local()


class DeferredInitializationError(MXNetError):
    """Parameter used before its shape was known."""


class _Override:
    def __init__(self, mapping):
        self.mapping = mapping
        self.writes = {}

    def __enter__(self):
        if not hasattr(_tls, "stack"):
            _tls.stack = []
        _tls.stack.append(self)
        return self

    def __exit__(self, *a):
        _tls.stack.pop()


def override(mapping):
    """Scope in which `Parameter.data()` returns `mapping[param]` and
    `set_data` is captured in ``.writes`` instead of applied."""
    return _Override(mapping)


def tracing_overrides():
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class Parameter:
    """A weight (reference: gluon/parameter.py:Parameter)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise NotImplementedError(
                "sparse parameters (stype=%r, grad_stype=%r) need the "
                "sparse NDArray, ROADMAP Queue 1 item 11"
                % (stype, grad_stype))
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_stype = "default"
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None  # dict ctx -> NDArray
        self._grad = None  # dict ctx -> NDArray, or None for "null"
        self._deferred_init = None

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                for d in self._data.values():
                    d._grad, d._grad_req = None, "null"
                    d._data = d._data.detach()
        elif self._data is not None:
            self._init_grad()

    def _init_grad(self):
        from .. import autograd

        self._grad = {c: nd.zeros(self.shape, ctx=c, dtype=self.dtype)
                      for c in self._data}
        for c, d in self._data.items():
            autograd.mark_variables([d], [self._grad[c]],
                                    grad_reqs=self._grad_req)

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter '%s' has not been initialized yet because "
                    "initialization was deferred. Call net(data) once to "
                    "trigger shape inference, or set shape explicitly."
                    % self.name)
            raise RuntimeError("Parameter '%s' has not been initialized. "
                               "Call initialize() first." % self.name)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and initialize on ctx(s); deferred while the shape
        is unknown."""
        from .. import initializer as _initializer

        if self._data is not None and not force_reinit:
            return
        # A parameter-specific init (an explicit arg or self.init, such
        # as Dense's bias_initializer) bypasses the name-suffix dispatch.
        specific = init is not None or self.init is not None
        if init is None:
            init = self.init if self.init is not None else \
                (default_init if default_init is not None else
                 _initializer.Uniform())
        init = _initializer.create(init)
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self.shape is None or any(s <= 0 for s in self.shape):
            if not self.allow_deferred_init:
                raise ValueError("Cannot initialize parameter %s with "
                                 "unknown shape %s" % (self.name, self.shape))
            self._deferred_init = (init, list(ctx), specific)
            return
        self._finish_init(init, ctx, specific)

    def _finish_init(self, init, ctx_list, specific=False):
        from .. import initializer as _initializer

        data = np.zeros(self.shape, dtype=numpy_dtype(self.dtype))
        desc = _initializer.InitDesc(self.name,
                                     {"__init__": init} if specific else None)
        data = init(desc, data)
        self._data = {c: nd.array(data, ctx=c, dtype=self.dtype)
                      for c in ctx_list}
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _finish_deferred_init(self, shape):
        if self._deferred_init is None:
            return
        if self.shape is None:
            self.shape = tuple(shape)
        else:
            self.shape = tuple(s if s > 0 else n
                               for s, n in zip(self.shape, shape))
        init, ctx, specific = self._deferred_init
        self._finish_init(init, ctx, specific)

    # -- access ---------------------------------------------------------------

    def data(self, ctx=None):
        ov = tracing_overrides()
        if ov is not None and self in ov.mapping:
            return ov.mapping[self]
        self._check_initialized()
        if ctx is None:
            return next(iter(self._data.values()))
        ctx = Context(ctx)
        if ctx not in self._data:
            raise RuntimeError("Parameter '%s' was not initialized on "
                               "context %s" % (self.name, ctx))
        return self._data[ctx]

    def list_data(self):
        self._check_initialized()
        return list(self._data.values())

    def list_ctx(self):
        self._check_initialized()
        return list(self._data)

    @property
    def grad_stype(self):
        return self._grad_stype

    def cast(self, dtype):
        """Re-type the data (and, for a trainable parameter, fresh zero
        gradient buffers) to `dtype` (reference parameter.py:cast)."""
        self.dtype = dtype
        if self._data is not None:
            self._data = {c: d.astype(dtype) for c, d in self._data.items()}
            if self._grad_req != "null":
                self._init_grad()

    def grad(self, ctx=None):
        if self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for parameter '%s' because "
                "grad_req='null'" % self.name)
        if ctx is None:
            return next(iter(self._grad.values()))
        return self._grad[Context(ctx)]

    def list_grad(self):
        return list(self._grad.values()) if self._grad else []

    def zero_grad(self):
        if self._grad is None:
            return
        for g in self._grad.values():
            g._set_data(torch.zeros_like(g._data))

    def set_data(self, data):
        """Set the value on every context; inside `override` the write
        is captured instead."""
        ov = tracing_overrides()
        if ov is not None and self in ov.mapping:
            ov.writes[self] = data
            return
        if self._data is None:
            if self._deferred_init is None:
                raise RuntimeError("Parameter '%s' not initialized"
                                   % self.name)
            self.shape = tuple(data.shape)
            init, ctx, specific = self._deferred_init
            self._finish_init(init, ctx, specific)
        for c, d in self._data.items():
            src = data.as_in_context(c) if isinstance(data, NDArray) else \
                nd.array(data, ctx=c)
            d._set_data(src._data)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)


class ParameterDict:
    """Ordered name -> Parameter mapping with prefix scoping."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def get(self, name, **kwargs):
        """Get or create the parameter named prefix + name."""
        full = self._prefix + name
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
        elif full in self._params:
            param = self._params[full]
        else:
            param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)
