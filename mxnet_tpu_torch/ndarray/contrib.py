"""`mx.nd.contrib` — the contrib operator namespace and the control-flow
helpers ``foreach``, ``while_loop`` and ``cond``.

Counterpart of ``mxnet_tpu/ndarray/contrib.py:41-170`` (reference
python/mxnet/ndarray/contrib.py). ``nd.contrib.<name>`` resolves the
registered ``_contrib_<name>``, then ``<name>``.

The helpers run Python loops over NDArray ops, so under
``autograd.record()`` every iteration lands on the tape, as on the
reference's imperative path. ``while_loop`` has the JAX package's two
results: called imperatively it stacks exactly the executed steps;
inside a hybridized block's call (a :class:`~mxnet_tpu_torch.cached_op.
CachedOp`, where the JAX package traces) it pads the outputs to
``max_iterations`` rows with zeros, as the traced JAX op does. A
predicate is read on the host (``ops.control_flow.PREDICATE_READS``).
"""
from __future__ import annotations

from ..ops import control_flow as _cf
from ..ops import registry as _registry

__all__ = ["foreach", "while_loop", "cond"]


def _norm(x):
    """-> (list, was_single)."""
    from .ndarray import NDArray

    if isinstance(x, NDArray):
        return [x], True
    if x is None:
        return [], True
    return list(x), False


def _denorm(lst, single):
    return lst[0] if single and len(lst) == 1 else lst


def _truth(value):
    """A predicate's truth: an NDArray is read on the host."""
    from .ndarray import NDArray

    if isinstance(value, NDArray):
        return _cf.read_predicate(value._data)
    return bool(value)


def _stack(steps):
    from . import __getattr__ as _nd

    return [_nd("stack")(*[s[i] for s in steps], axis=0)
            for i in range(len(steps[0]))] if steps else []


def foreach(body, data, init_states, name="foreach"):
    """Scan `body` over axis 0 of `data` (reference contrib.foreach):
    body(data_slice, states) -> (outputs, new_states). Returns (outputs
    stacked along axis 0, final states)."""
    data_list, data_single = _norm(data)
    if not data_list:
        raise ValueError("foreach needs at least one data array")
    states = init_states
    steps, out_single = [], True
    for t in range(data_list[0].shape[0]):
        outs, states = body(_denorm([d[t] for d in data_list], data_single),
                            states)
        outs, out_single = _norm(outs)
        steps.append(outs)
    return _denorm(_stack(steps), out_single), states


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Run `func` while `cond` holds (reference contrib.while_loop):
    cond(*loop_vars) -> scalar truth; func(*loop_vars) -> (step_output,
    new_loop_vars). Outputs are stacked over the executed steps, padded
    to `max_iterations` rows inside a hybridized call."""
    from .. import autograd
    from ..cached_op import in_cached_call
    from .ndarray import zeros

    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    limit = int(max_iterations)
    cur, vars_single = _norm(loop_vars)
    steps, out_single = [], True
    while len(steps) < limit and _truth(cond(*cur)):
        outs, new_vars = func(*cur)
        outs, out_single = _norm(outs)
        steps.append(outs)
        cur, _ = _norm(new_vars)
    stacked = _stack(steps)
    if in_cached_call():
        if not steps:
            # The outputs' shapes, from one step that is not kept.
            with autograd.pause():
                probe, out_single = _norm(func(*cur)[0])
            stacked = [zeros((0,) + o.shape, ctx=o.context, dtype=o.dtype)
                       for o in probe]
        from . import __getattr__ as _nd

        def pad(o):
            rows = zeros((limit - o.shape[0],) + o.shape[1:], ctx=o.context,
                         dtype=o.dtype)
            return _nd("concat")(o, rows, dim=0)

        stacked = [pad(o) if o.shape[0] < limit else o for o in stacked]
    return _denorm(stacked, out_single), _denorm(cur, vars_single)


def cond(pred, then_func, else_func, name="cond"):
    """Run then_func() or else_func() as `pred` (a thunk or a one-element
    NDArray) holds (reference contrib.cond); only that branch runs."""
    p = pred() if callable(pred) else pred
    return then_func() if _truth(p) else else_func()


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import __getattr__ as _nd_getattr

    for candidate in ("_contrib_" + name, name):
        try:
            _registry.get(candidate)
        except AttributeError:
            continue
        return _nd_getattr(candidate)
    raise AttributeError("contrib operator %r is not registered" % name)
