"""`mx.sym.contrib` — symbolic control flow, and the contrib operators.

Counterpart of ``mxnet_tpu/symbol_contrib.py`` (reference
python/mxnet/symbol/contrib.py). ``foreach``/``while_loop``/``cond``
build ``_foreach``/``_while_loop``/``_cond`` nodes whose sub-graphs are
cut out of the enclosing graph: every leaf variable the sub-graph reads
that is not one of its placeholders becomes an input of the node
(reference ``_cut_subgraph``). The node's attrs carry a
:class:`~mxnet_tpu_torch.ops.control_flow.SymSubgraph`, which runs the
sub-graph through the Executor's plan, compiled once per training mode.

Such graphs bind, run, differentiate and infer shapes, but ``tojson()``
writes the sub-graph attrs as opaque strings, as the JAX package does:
control-flow graphs do not round-trip through JSON (the reference
embeds sub-graphs in its JSON).
"""
from __future__ import annotations

from .ops.control_flow import SymSubgraph
from .symbol import Symbol, _auto_name

__all__ = ["foreach", "while_loop", "cond"]


def _norm(x):
    if isinstance(x, Symbol):
        return [x], True
    if x is None:
        return [], True
    return list(x), False


def _denorm(lst, single):
    return lst[0] if single and len(lst) == 1 else lst


def _leaves(out_syms):
    seen, order = set(), []
    for s in out_syms:
        for n in s._topo():
            if n._op is None and id(n) not in seen:
                seen.add(id(n))
                order.append(n)
    return order


def _cut(out_syms, placeholders):
    """Free variables of the sub-graph, in deterministic order
    (reference _cut_subgraph)."""
    ph_ids = {id(p) for p in placeholders}
    return [n for n in _leaves(out_syms) if id(n) not in ph_ids]


def foreach(body, data, init_states, name=None):
    """body(data_slice_sym, state_syms) -> (out_syms, new_state_syms);
    returns (stacked outputs, final states) symbols."""
    name = name or _auto_name("foreach")
    data_list, data_single = _norm(data)
    states_list, states_single = _norm(init_states)
    data_ph = [Symbol(None, name="%s_data%d" % (name, i))
               for i in range(len(data_list))]
    state_ph = [Symbol(None, name="%s_state%d" % (name, i))
                for i in range(len(states_list))]
    outs, new_states = body(_denorm(list(data_ph), data_single),
                            _denorm(list(state_ph), states_single))
    out_syms, out_single = _norm(outs)
    state_syms, _ = _norm(new_states)
    captured = _cut(out_syms + state_syms, data_ph + state_ph)
    sub = SymSubgraph([p._name for p in data_ph + state_ph],
                      [c._name for c in captured], out_syms + state_syms)
    n_out = len(out_syms) + len(state_syms)
    node = Symbol("_foreach",
                  attrs={"_op_name": "_foreach", "body": sub,
                         "n_data": len(data_list),
                         "n_states": len(states_list)},
                  inputs=data_list + states_list + captured,
                  name=name, num_outputs=n_out)
    outs_o = [node[i] for i in range(len(out_syms))]
    finals = [node[len(out_syms) + i] for i in range(len(state_syms))]
    return _denorm(outs_o, out_single), _denorm(finals, states_single)


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """cond(*loop_vars) -> scalar sym; func(*loop_vars) ->
    (out_syms, new_loop_vars). Outputs are padded to `max_iterations`
    rows, and the node has the validity mask as its last output
    (ops/control_flow.py)."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    name = name or _auto_name("while_loop")
    vars_list, vars_single = _norm(loop_vars)
    var_ph = [Symbol(None, name="%s_var%d" % (name, i))
              for i in range(len(vars_list))]
    cond_sym = cond(*var_ph)
    outs, new_vars = func(*var_ph)
    out_syms, out_single = _norm(outs)
    new_var_syms, _ = _norm(new_vars)
    captured = _cut([cond_sym] + out_syms + new_var_syms, var_ph)
    ph_names = [p._name for p in var_ph]
    cap_names = [c._name for c in captured]
    cond_sub = SymSubgraph(ph_names, cap_names, [cond_sym])
    func_sub = SymSubgraph(ph_names, cap_names, out_syms + new_var_syms)
    n_out = len(out_syms) + len(new_var_syms) + 1      # + valid mask
    node = Symbol("_while_loop",
                  attrs={"_op_name": "_while_loop", "cond": cond_sub,
                         "func": func_sub, "n_vars": len(vars_list),
                         "max_iterations": int(max_iterations)},
                  inputs=vars_list + captured, name=name, num_outputs=n_out)
    outs_o = [node[i] for i in range(len(out_syms))]
    finals = [node[len(out_syms) + i] for i in range(len(new_var_syms))]
    return _denorm(outs_o, out_single), _denorm(finals, vars_single)


def cond(pred, then_func, else_func, name=None):
    """pred/then_func/else_func: thunks over enclosing symbols; both
    branches must produce the same output structure."""
    name = name or _auto_name("cond")
    pred_sym = pred() if callable(pred) else pred
    then_syms, then_single = _norm(then_func())
    else_syms, _ = _norm(else_func())
    if len(then_syms) != len(else_syms):
        raise ValueError("cond branches must have the same number of "
                         "outputs (%d vs %d)"
                         % (len(then_syms), len(else_syms)))
    captured = _cut([pred_sym] + then_syms + else_syms, [])
    cap_names = [c._name for c in captured]
    node = Symbol("_cond",
                  attrs={"_op_name": "_cond",
                         "pred": SymSubgraph([], cap_names, [pred_sym]),
                         "then_g": SymSubgraph([], cap_names, then_syms),
                         "else_g": SymSubgraph([], cap_names, else_syms)},
                  inputs=captured, name=name, num_outputs=len(then_syms))
    outs = [node[i] for i in range(len(then_syms))]
    return _denorm(outs, then_single)


def __getattr__(attr):
    if attr.startswith("__"):
        raise AttributeError(attr)
    from .symbol import __getattr__ as _sym_getattr

    for candidate in ("_contrib_" + attr, attr):
        try:
            return _sym_getattr(candidate)
        except AttributeError:
            continue
    raise AttributeError("contrib symbol %r is not registered" % attr)
