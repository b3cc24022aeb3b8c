"""Imperative autograd over torch.autograd.

Counterpart of ``mxnet_tpu/autograd.py``: the ``record``/``pause``/
``train_mode``/``predict_mode`` scopes, ``mark_variables``,
``backward``, ``grad`` and ``Function``.

The JAX package keeps its own tape of (op, input snapshot) nodes; here
the tape is torch's graph. An op dispatched while the thread *builds a
graph* (inside ``record()``) runs with torch's grad mode on; everywhere
else it runs with grad mode off, so outside ``record()`` no op builds a
graph, as in the reference. ``record()`` and ``pause()`` also set
``torch.set_grad_enabled`` for the scope, for torch code run inside it.

Leaves. In the reference every NDArray read by a recorded op is a
potential leaf: ``grad(heads, [x])`` works for any such ``x``, and
``backward`` commits into ``x.grad`` only for arrays marked with
``attach_grad``/``mark_variables``. Here a floating NDArray read by a
recorded op is made a leaf of torch's graph (its tensor gets
``requires_grad``). A marked array whose tensor is replaced after it was
recorded (``x += 1``, an ``out=`` write, ``Parameter.set_data``) keeps
its earlier leaves alive in a weak list, so a pending backward still
reaches it: the reference's tape reads the snapshot it recorded.

``train_mode`` of ``backward``/``grad`` is accepted and ignored, as in
the reference: the forward already ran in the mode it was recorded in.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function",
]

_state = threading.local()

# Every NDArray marked by mark_variables/attach_grad while it lives, by
# id: NDArray's == is elementwise, so it cannot key a set itself.
_VARIABLES = weakref.WeakValueDictionary()
_VARIABLES_LOCK = threading.Lock()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.graph = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def builds_graph():
    """Whether ops dispatched now build a torch graph: inside
    ``record()``, and inside the train step's own differentiation
    scope, where recording is paused as in the reference."""
    return _st().graph


def set_recording(flag):
    st = _st()
    prev, st.recording = st.recording, flag
    st.graph = bool(flag)
    return prev


def set_training(flag):
    st = _st()
    prev, st.training = st.training, flag
    return prev


class _RecordingScope:
    """Sets recording/training (None leaves one as it is); `graph`
    defaults to the recording flag, and with it torch's grad mode."""

    def __init__(self, recording, training, graph=None):
        self._recording = recording
        self._training = training
        self._graph = recording if graph is None else graph

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training, st.graph)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        if self._graph is not None:
            st.graph = self._graph
            self._grad_mode = torch.set_grad_enabled(self._graph)
            self._grad_mode.__enter__()
        return self

    def __exit__(self, *a):
        if self._graph is not None:
            self._grad_mode.__exit__(*a)
        st = _st()
        st.recording, st.training, st.graph = self._prev

    def __call__(self, fn):
        def wrapped(*args, **kwargs):
            with self.__class__(self._recording, self._training,
                                self._graph):
                return fn(*args, **kwargs)

        return wrapped


def record(train_mode=True):
    """Scope in which executed ops are recorded for ``backward``
    (reference: python/mxnet/autograd.py:122)."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def _differentiate(train_mode=True):
    """The train step's scope: recording paused (``is_recording()`` is
    False, as under the reference's ``pause(train_mode=True)`` inside
    its traced step) while ops still build the torch graph that the
    step differentiates."""
    return _RecordingScope(False, train_mode, graph=True)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _make_leaf(nd):
    """Called by dispatch while building a graph, for each NDArray input:
    a floating tensor that is not yet in any graph becomes a leaf."""
    t = nd._data
    if not t.requires_grad and t.is_floating_point():
        t.requires_grad_(True)


def _retire(nd, old):
    """`nd` is about to drop tensor `old`: keep it reachable for a
    pending backward while a graph still holds it."""
    if old.requires_grad:
        nd._ag_retired = [r for r in nd._ag_retired if r() is not None]
        nd._ag_retired.append(weakref.ref(old))


def _leaves(nd):
    """Tensors that stand for `nd` in recorded graphs: its current
    tensor and the live retired ones."""
    out = [nd._data] if nd._data.requires_grad else []
    out += [t for t in (r() for r in nd._ag_retired)
            if t is not None and t is not nd._data]
    return out


def mark_variables(variables, gradients, grad_reqs="write", grad_req=None):
    """Reference: MXAutogradMarkVariables."""
    if grad_req is not None:
        grad_reqs = grad_req
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        t = v._data
        if t.is_floating_point() and not (t.requires_grad and t.is_leaf):
            # A leaf of its own; gradients stop here, as the reference
            # drops a marked array's tape node.
            v._data = t.detach().requires_grad_(True)
        with _VARIABLES_LOCK:
            _VARIABLES[id(v)] = v


def _head_tensors(heads, head_grads):
    """(outputs, grad_outputs) of the heads that are in a graph. Raises
    for a head that was neither recorded nor marked."""
    from .ndarray.ndarray import NDArray

    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not (h._data.requires_grad or h._recorded or h._grad is not None):
            raise ValueError(
                "cannot differentiate a head that was not computed under "
                "autograd.record() nor marked with attach_grad()")
        if not h._data.requires_grad:
            continue  # recorded from constants only: no leaf behind it
        g = hg._data if isinstance(hg, NDArray) else (
            hg if hg is not None else torch.ones_like(h._data))
        outs.append(h._data)
        grads.append(g.to(h._data.device, h._data.dtype))
    return outs, grads


def _gradients(heads, head_grads, variables, retain_graph):
    """Per variable, the gradient of the heads summed over its leaves,
    or None where no head depends on it."""
    outs, grads = _head_tensors(heads, head_grads)
    groups = [_leaves(v) for v in variables]
    flat = [t for g in groups for t in g]
    if outs and flat:
        with torch.enable_grad():
            got = iter(torch.autograd.grad(outs, flat, grads,
                                           retain_graph=retain_graph,
                                           allow_unused=True))
    else:
        got = iter([None] * len(flat))
    sums = []
    for group in groups:
        total = None
        for _ in group:
            g = next(got)
            if g is not None:
                total = g if total is None else total + g
        sums.append(total)
    return sums


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run backward from `heads`, writing into each marked variable's
    `.grad` per its grad_req (reference: Imperative::Backward
    imperative.cc:270): ``"write"`` overwrites, ``"add"`` accumulates,
    and a variable no head depends on keeps its gradient."""
    with _VARIABLES_LOCK:
        marked = [v for v in _VARIABLES.values()
                  if v._grad is not None and v._grad_req != "null"]
    sums = _gradients(heads, head_grads, marked, bool(retain_graph))
    with torch.no_grad():
        for v, g in zip(marked, sums):
            if g is None:
                continue
            if v._grad_req == "add":
                v._grad._set_data(v._grad._data + g)
            else:
                v._grad._set_data(g.to(v._grad._data.dtype))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Reference: mx.autograd.grad — gradients of `heads` with respect
    to `variables` (any arrays read by recorded ops), without touching
    `.grad` buffers; zeros for a variable no head depends on."""
    from .ndarray.ndarray import NDArray

    if create_graph:
        raise NotImplementedError(
            "create_graph=True (higher-order autograd through the tape) is "
            "not supported")
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    variables = list(variables)
    sums = _gradients(list(heads), head_grads, variables,
                      bool(retain_graph))
    return [NDArray(g.detach() if g is not None
                    else torch.zeros_like(v._data.detach()), ctx=v.context)
            for v, g in zip(variables, sums)]


# ---------------------------------------------------------------------------
# user-defined functions
# ---------------------------------------------------------------------------

class _Bridge(torch.autograd.Function):
    """Carries a :class:`Function` through torch's graph: its NDArray
    forward and backward run with recording paused."""

    @staticmethod
    def forward(ctx, func, contexts, *tensors):
        from .ndarray.ndarray import NDArray

        ctx.func, ctx.contexts = func, contexts
        with pause(is_training()):
            out = func.forward(*[NDArray(t.detach(), ctx=c)
                                 for t, c in zip(tensors, contexts)])
        ctx.multi = isinstance(out, (tuple, list))
        outs = list(out) if ctx.multi else [out]
        ctx.out_contexts = [o.context for o in outs]
        return tuple(o._data for o in outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        with pause():
            res = ctx.func.backward(*[NDArray(g, ctx=c) for g, c in
                                      zip(grads, ctx.out_contexts)])
        if not isinstance(res, (tuple, list)):
            res = (res,)
        return (None, None) + tuple(
            r._data if isinstance(r, NDArray) else r for r in res)


class Function:
    """User-defined differentiable function (reference:
    mx.autograd.Function, python/mxnet/autograd.py:Function): subclass
    and define ``forward(*inputs)`` and ``backward(*output_grads)`` over
    NDArrays; state for the backward is kept on ``self``."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not builds_graph():
            return self.forward(*inputs)
        for x in inputs:
            _make_leaf(x)
        outs = _Bridge.apply(self, [x.context for x in inputs],
                             *[x._data for x in inputs])
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        wrapped = []
        for t in outs:
            o = NDArray(t)
            o._recorded = True
            wrapped.append(o)
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)
