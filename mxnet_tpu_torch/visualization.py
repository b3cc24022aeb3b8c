"""mx.visualization — network summaries and graph plots: counterpart of
``mxnet_tpu/visualization.py``.

Reference: python/mxnet/visualization.py (print_summary walks the
symbol's JSON graph printing a layer/shape/params table; plot_network
renders graphviz). The summary is computed from the live Symbol DAG +
infer_shape; plot_network emits DOT (and renders only if the optional
graphviz package exists — same optional dependency as the reference).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["print_summary", "plot_network"]


def _param_count(node, shapes):
    """Learnable parameter count feeding `node` (direct variable inputs
    that look like parameters — not data/label)."""
    total = 0
    for inp in node._inputs:
        if inp._op is None and inp._name and not inp._is_aux and \
                inp._name not in ("data", "label", "softmax_label"):
            s = shapes.get(inp._name)
            if s:
                total += int(np.prod(s))
    return total


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer table (reference visualization.py:print_summary).

    `shape`: dict of input name -> shape for shape inference.
    """
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    shapes = {}
    out_shapes = {}
    if shape:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        shapes = dict(zip(symbol.list_arguments(), arg_shapes))
        # per-node output shapes
        known = {k: tuple(v) for k, v in shape.items()}
        known.update({k: tuple(v) for k, v in shapes.items() if v})
        all_shapes = symbol._infer_all_shapes(known)
        for node in symbol._topo():
            s = all_shapes.get(("out", node._uid, node._out_index or 0))
            if s is not None:
                out_shapes[node._uid] = s

    positions = [int(line_length * p) for p in positions]
    headers = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields):
        line = ""
        for i, f in enumerate(fields):
            line += str(f)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(headers)
    print("=" * line_length)
    total = 0
    for node in symbol._topo():
        if node._op is None or node._op == "_group":
            continue
        op_name = node._attrs.get("_op_name", node._op)
        n_params = _param_count(node, shapes)
        total += n_params
        prev = ",".join(i._name or (i._op or "") for i in node._inputs
                        if not (i._op is None and i._name and
                                (i._name.endswith("_weight")
                                 or i._name.endswith("_bias")
                                 or i._name.endswith("_gamma")
                                 or i._name.endswith("_beta"))))
        print_row(["%s (%s)" % (node._name or op_name, op_name),
                   out_shapes.get(node._uid, ""), n_params, prev])
    print("=" * line_length)
    print("Total params: %d" % total)
    print("_" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz Digraph of the network (reference
    visualization.py:plot_network). Returns the graphviz object when the
    optional `graphviz` package is installed; otherwise returns the DOT
    source string (the graph itself — renderable elsewhere)."""
    node_attrs = node_attrs or {}
    lines = ["digraph %s {" % json.dumps(title),
             '  rankdir=BT;']
    index = {}
    for i, node in enumerate(symbol._topo()):
        if node._op == "_group":
            continue
        if node._uid in index:
            continue
        index[node._uid] = i
        if node._op is None:
            if hide_weights and node._name and (
                    node._name.endswith("_weight")
                    or node._name.endswith("_bias")
                    or node._name.endswith("_gamma")
                    or node._name.endswith("_beta")
                    or node._name.endswith("_moving_mean")
                    or node._name.endswith("_moving_var")):
                continue
            label = node._name or "var"
            shape_attr = "oval"
        else:
            op_name = node._attrs.get("_op_name", node._op)
            label = "%s\\n%s" % (node._name or op_name, op_name)
            shape_attr = "box"
        lines.append('  n%d [label=%s, shape=%s];'
                     % (i, json.dumps(label), shape_attr))
    for node in symbol._topo():
        if node._op in (None, "_group") or node._uid not in index:
            continue
        for inp in node._inputs:
            if inp._uid in index:
                lines.append("  n%d -> n%d;"
                             % (index[inp._uid], index[node._uid]))
    lines.append("}")
    dot_src = "\n".join(lines)
    try:
        import graphviz  # optional, like the reference

        g = graphviz.Source(dot_src)
        return g
    except ImportError:
        return dot_src
