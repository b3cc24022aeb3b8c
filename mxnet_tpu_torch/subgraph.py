"""Subgraph partitioning — the "hand this fragment to a backend" hook.

Counterpart of ``mxnet_tpu/subgraph.py`` (reference
src/operator/subgraph/subgraph_property.h: SubgraphProperty and
SubgraphSelector walk the graph, select connected op sets and replace
each with one subgraph node run by a backend; MXNET_SUBGRAPH_BACKEND /
partition_graph).

A matched fragment becomes ONE `_subgraph` node whose function is
supplied by the backend: a function of torch tensors, naturally a
kernel compiled at runtime through ``mxnet_tpu_torch.rtc.CudaModule``
(see ``examples/fused_bn_relu.py``). Without a function the node
evaluates its embedded sub-DAG, so partitioning always keeps the
graph's semantics.

API (the reference's registration workflow):

    class FuseDenseRelu(subgraph.SubgraphProperty):
        def select(self, node): return node._op == "Activation"
        def select_input(self, node, inp): return inp._op == "FullyConnected"
        def create_fn(self, sub_sym, arg_names):
            def fused(x, w, b):  # torch tensors, e.g. an rtc kernel
                ...
            return fused

    subgraph.register_backend("dense_relu", FuseDenseRelu())
    psym = subgraph.partition(sym, "dense_relu")   # or a property instance
    psym.bind(...).forward(...)
"""
from __future__ import annotations

__all__ = ["SubgraphSelector", "SubgraphProperty", "register_backend",
           "list_backends", "partition"]

_BACKENDS: dict[str, "SubgraphProperty"] = {}


class SubgraphSelector:
    """Decides which nodes join a selection (reference
    subgraph_property.h:SubgraphSelector — SelectInput grows toward
    producers, SelectOutput toward consumers; the union is an arbitrary
    connected set). Default: nothing."""

    def select(self, node):
        """Start a selection at this node?"""
        return False

    def select_input(self, node, input_node):
        """Grow the selection from `node` into its producer?"""
        return False

    def select_output(self, node, output_node):
        """Grow the selection from `node` into a consumer?"""
        return False


class SubgraphProperty(SubgraphSelector):
    """A backend: selection rules + the replacement executor
    (reference subgraph_property.h:SubgraphProperty). Subclasses
    override the selector methods and (optionally) `create_fn`.

    ``inference_only = True`` additionally admits aux-consuming ops
    (BatchNorm with its moving stats) into fragments: their aux become
    plain fragment inputs. Only valid for graphs executed in inference
    mode — train-mode aux WRITES inside a fragment would be dropped —
    matching the reference's inference-time properties (TensorRT,
    quantization)."""

    name = None
    inference_only = False

    def create_fn(self, sub_sym, arg_names):
        """Return a callable `fn(*arg_tensors) -> tensor(s)` replacing
        the fragment, or None to keep the embedded sub-DAG as the
        executor (still useful: the fragment is isolated for inspection
        and can be re-targeted later)."""
        return None


def register_backend(name, prop):
    """Register a property under a backend name (reference
    MXNET_SUBGRAPH_BACKEND names)."""
    prop.name = name
    _BACKENDS[name] = prop
    return prop


def list_backends():
    return sorted(_BACKENDS)


def _resolve(backend):
    if isinstance(backend, SubgraphProperty):
        return backend
    try:
        return _BACKENDS[backend]
    except KeyError:
        raise ValueError("unknown subgraph backend %r; registered: %s"
                         % (backend, list_backends())) from None


def partition(symbol, backend):
    """Replace every maximal matched fragment of `symbol` with a
    `_subgraph` node (reference build_subgraph/partition_graph pass).

    Fragments are CONNECTED SETS: each seed (`select`) grows toward
    producers (`select_input`) and consumers (`select_output`), exactly
    the reference SubgraphSelector contract. A fragment may have
    multiple outputs — every member whose value is consumed outside the
    fragment (or is a graph output) becomes one output of the
    `_subgraph` node. Non-convex selections (a path that leaves the
    fragment and re-enters, which would create a cycle after
    substitution) are trimmed member-by-member. Returns a new Symbol
    sharing unmatched nodes."""
    from .symbol import Symbol

    prop = _resolve(backend)
    out_syms = symbol.outputs if symbol._op == "_group" else [symbol]
    nodes = _group_topo(out_syms)     # base nodes only, topo order
    graph_out_uids = {s._uid for s in out_syms}

    consumers: dict[int, list] = {}
    for node in nodes:
        for inp in node._inputs:
            consumers.setdefault(inp._uid, []).append(node)

    def _fusable(node):
        """Fragment members must be single-output, stateless ops:
        multi-output views and aux-consuming ops (BatchNorm moving
        stats) are excluded — aux writes inside a fragment would be
        silently dropped."""
        return (node._op is not None and node._op != "_subgraph"
                and node._num_outputs == 1 and node._out_index is None
                and (getattr(prop, "inference_only", False)
                     or not any(i._op is None and i._is_aux
                                for i in node._inputs)))

    # -- pass 1: discover fragments ---------------------------------------

    assigned: dict[int, int] = {}     # member uid -> fragment id
    fragments: list[set] = []

    def make_convex(members):
        """Drop members until no path exits and re-enters the fragment
        (a member consuming an external value that itself depends on a
        member would become a cycle once the fragment is one node)."""
        while True:
            dep = {}                  # uid -> depends on a member?
            bad = None
            for n in nodes:
                d = False
                for i in n._inputs:
                    if i._op is None:
                        continue
                    if i._uid in members or dep.get(i._uid):
                        d = True
                if n._uid in members and any(
                        i._op is not None and i._uid not in members
                        and dep.get(i._uid) for i in n._inputs):
                    bad = n._uid
                dep[n._uid] = d
            if bad is None:
                return members
            members.discard(bad)

    for node in nodes:
        if node._op is None or node._uid in assigned:
            continue
        if not _fusable(node) or not prop.select(node):
            continue
        members = {node._uid}
        frontier = [node]
        while frontier:
            n = frontier.pop()
            for inp in n._inputs:
                if (inp._op is None or inp._uid in members
                        or inp._uid in assigned):
                    continue
                if _fusable(inp) and prop.select_input(n, inp):
                    members.add(inp._uid)
                    frontier.append(inp)
            for c in consumers.get(n._uid, ()):
                if c._uid in members or c._uid in assigned:
                    continue
                if _fusable(c) and prop.select_output(n, c):
                    members.add(c._uid)
                    frontier.append(c)
        members = make_convex(members)
        if len(members) > 1:
            fid = len(fragments)
            for uid in members:
                assigned[uid] = fid
            fragments.append(members)

    if not fragments:
        return symbol

    # -- pass 2: rebuild --------------------------------------------------

    _SHARED = object()                # "region untouched, reuse original"
    clones: dict[int, Symbol] = {}    # non-member base uid -> clone
    frag_nodes: dict[int, Symbol] = {}
    frag_out_pos: dict[tuple, int] = {}
    frag_n_out: dict[int, int] = {}

    def rebuild_view(sym):
        if sym._op is None:
            return sym
        fid = assigned.get(sym._uid)
        if fid is not None:
            fnode = build_frag(fid)
            pos = frag_out_pos[(fid, sym._uid)]
            if frag_n_out[fid] == 1:
                return fnode
            view = fnode[pos]
            # Views are fresh Symbols sharing the base's uid/inputs; the
            # executor reads the fragment payload off whichever node it
            # sees first, so views must carry it too.
            for attr in ("_sub_sym", "_sub_arg_names", "_sub_fn"):
                setattr(view, attr, getattr(fnode, attr))
            return view
        base = clones.get(sym._uid)
        if base is None:
            new_inputs = [rebuild_view(i) for i in sym._inputs]
            if all(a is b for a, b in zip(new_inputs, sym._inputs)):
                # Untouched region: a SENTINEL, never the node we
                # happened to enter through — caching a VIEW here would
                # hand later base/other-view requests the wrong slot.
                base = _SHARED
            else:
                # Views carry the base's op/attrs/inputs, so a proper
                # base clone (no out_index) builds from either.
                base = Symbol(sym._op, attrs=dict(sym._attrs),
                              inputs=new_inputs, name=sym._name,
                              num_outputs=sym._num_outputs)
                for attr in ("_sub_sym", "_sub_arg_names", "_sub_fn"):
                    if hasattr(sym, attr):
                        setattr(base, attr, getattr(sym, attr))
            clones[sym._uid] = base
        if base is _SHARED:
            return sym
        if sym._out_index is not None:
            return base[sym._out_index]
        return base

    def build_frag(fid):
        hit = frag_nodes.get(fid)
        if hit is not None:
            return hit
        members = fragments[fid]
        order = [n for n in nodes if n._uid in members]
        outputs = [n for n in order
                   if n._uid in graph_out_uids
                   or any(c._uid not in members
                          for c in consumers.get(n._uid, ()))]
        if not outputs:               # every member internal?! keep seed
            outputs = [order[-1]]

        # External edges in first-use order -> node inputs + sub vars.
        ext, seen = [], set()
        for n in order:
            for inp in n._inputs:
                if inp._uid in members:
                    continue
                key = (inp._uid, inp._out_index)
                if key not in seen:
                    seen.add(key)
                    ext.append(inp)
        arg_names, var_of = [], {}
        for i, e in enumerate(ext):
            nm = e._name if e._op is None else "sub_in%d" % i
            arg_names.append(nm)
            var_of[(e._uid, e._out_index)] = Symbol(None, name=nm)

        inner_cache = {}

        def clone_inner(sym):
            ph = var_of.get((sym._uid, sym._out_index))
            if ph is not None:
                return ph
            got = inner_cache.get(sym._uid)
            if got is not None:
                return got
            c = Symbol(sym._op, attrs=dict(sym._attrs),
                       inputs=[clone_inner(i) for i in sym._inputs],
                       name=sym._name, num_outputs=sym._num_outputs)
            inner_cache[sym._uid] = c
            return c

        sub_outs = [clone_inner(o) for o in outputs]
        if len(sub_outs) > 1:
            from . import symbol as _symmod

            sub_sym = _symmod.Group(sub_outs)
        else:
            sub_sym = sub_outs[0]
        new_inputs = [rebuild_view(e) for e in ext]
        fnode = Symbol("_subgraph",
                       attrs={"_op_name": "_subgraph",
                              "__subgraph_backend__": prop.name or
                              type(prop).__name__},
                       inputs=new_inputs,
                       name="%s_subgraph" % (outputs[0]._name or "fused"),
                       num_outputs=len(outputs))
        fnode._sub_sym = sub_sym
        fnode._sub_arg_names = list(arg_names)
        fnode._sub_fn = prop.create_fn(sub_sym, list(arg_names))
        for pos, o in enumerate(outputs):
            frag_out_pos[(fid, o._uid)] = pos
        frag_n_out[fid] = len(outputs)
        frag_nodes[fid] = fnode
        return fnode

    new_outs = [rebuild_view(s) for s in out_syms]
    if symbol._op == "_group":
        from . import symbol as _symmod

        return _symmod.Group(new_outs)
    return new_outs[0]


def _group_topo(out_syms):
    """Topological order over the union of several outputs' graphs."""
    seen = set()
    order = []

    def visit(node):
        if node._uid in seen and node._out_index is None:
            return
        key = (node._uid, node._out_index)
        if key in seen:
            return
        seen.add(node._uid if node._out_index is None else key)
        for i in node._inputs:
            visit(i)
        order.append(node)

    for s in out_syms:
        visit(s)
    # One representative per producer uid. A multi-output node reached
    # ONLY through views (sl[0], sl[1]) has no out_index-None entry, so
    # synthesize a base representative from a view — dropping it would
    # blind the consumer map and convexity check to its edges.
    from .symbol import Symbol

    rep: dict[int, "Symbol"] = {}
    uids_in_order = []
    for n in order:
        if n._uid not in rep:
            uids_in_order.append(n._uid)
        if n._out_index is None:
            rep[n._uid] = n
        elif n._uid not in rep:
            base = Symbol(n._op, n._attrs, n._inputs, n._name,
                          num_outputs=n._num_outputs, uid=n._uid)
            for attr in ("_sub_sym", "_sub_arg_names", "_sub_fn"):
                if hasattr(n, attr):
                    setattr(base, attr, getattr(n, attr))
            rep[n._uid] = base
    return [rep[u] for u in uids_in_order]
