"""mx.sym — the symbolic graph API.

Counterpart of ``mxnet_tpu/symbol.py`` (reference
python/mxnet/symbol/symbol.py: compose, infer_shape, list_arguments/
outputs/auxiliary_states, tojson/load, simple_bind, bind). A Symbol is a
small Python DAG over the same operator registry the imperative API
uses; ``bind`` gives an :class:`~mxnet_tpu_torch.executor.Executor`
that runs the graph eagerly on torch tensors.

Composition is the JAX package's: ``sym.FullyConnected(data=x,
num_hidden=10, name='fc1')`` auto-creates the missing ``fc1_weight``
and ``fc1_bias`` variables, BatchNorm's moving statistics become
auxiliary states, and scalars become node attributes. The JSON format
is the JAX package's own (``"mxnet_tpu_version": 1``, nodes with
op/name/attrs/inputs/is_aux/out_index/num_outputs), so a graph file
written by either package loads in the other and the same graph
serializes to the same string.

Shape inference runs each operator on tensors on PyTorch's ``meta``
device, where the JAX package calls ``jax.eval_shape``: shapes
propagate, no memory is touched. An operator that reads a value on the
host or allocates on a fixed device cannot run there and needs a shape
rule of its own.

``sym.contrib`` (``symbol_contrib.py``) composes the control-flow
operators. Their sub-graphs are node attrs that ``tojson()`` writes as
opaque strings, as the JAX package does: such a graph binds and runs,
but does not round-trip through JSON.
"""
from __future__ import annotations

import inspect
import json

import numpy as np
import torch

from .base import MXNetError
from .ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange"]

# Per-op learnable/aux inputs that composition auto-creates when not
# given (reference: each op's ListArguments/ListAuxiliaryStates), as
# op -> list of (param_name, is_aux, skip_if_attr).
_OP_PARAM_INPUTS = {
    "FullyConnected": [("weight", False, None), ("bias", False, "no_bias")],
    "Convolution": [("weight", False, None), ("bias", False, "no_bias")],
    "Deconvolution": [("weight", False, None), ("bias", False, "no_bias")],
    "BatchNorm": [("gamma", False, None), ("beta", False, None),
                  ("moving_mean", True, None), ("moving_var", True, None)],
    "LayerNorm": [("gamma", False, None), ("beta", False, None)],
    "InstanceNorm": [("gamma", False, None), ("beta", False, None)],
    "Embedding": [("weight", False, None)],
    "RNN": [("parameters", False, None)],
    # Loss heads auto-create their label input, named <name>_label.
    "SoftmaxOutput": [("label", False, None)],
    "LinearRegressionOutput": [("label", False, None)],
    "LogisticRegressionOutput": [("label", False, None)],
    "MAERegressionOutput": [("label", False, None)],
}

def _fc_shapes(attrs, dshape):
    num_hidden = int(attrs.get("num_hidden", 0))
    flatten = attrs.get("flatten", True)
    in_units = int(np.prod(dshape[1:])) if flatten else dshape[-1]
    out = {"weight": (num_hidden, in_units)}
    if not attrs.get("no_bias", False):
        out["bias"] = (num_hidden,)
    return out


def _conv_shapes(attrs, dshape):
    kernel = tuple(attrs.get("kernel", ()))
    num_filter = int(attrs.get("num_filter", 0))
    num_group = int(attrs.get("num_group", 1))
    out = {"weight": (num_filter, dshape[1] // num_group) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (num_filter,)
    return out


def _deconv_shapes(attrs, dshape):
    kernel = tuple(attrs.get("kernel", ()))
    num_filter = int(attrs.get("num_filter", 0))
    num_group = int(attrs.get("num_group", 1))
    out = {"weight": (dshape[1], num_filter // num_group) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (num_filter,)
    return out


def _ln_shapes(attrs, dshape):
    c = dshape[int(attrs.get("axis", -1))]
    return {"gamma": (c,), "beta": (c,)}


def _in_shapes(attrs, dshape):
    return {"gamma": (dshape[1],), "beta": (dshape[1],)}


def _regression_shapes(attrs, dshape):
    return {"label": tuple(dshape)}


def _bn_shapes(attrs, dshape):
    c = dshape[int(attrs.get("axis", 1))]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _embedding_shapes(attrs, dshape):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _rnn_shapes(attrs, dshape):
    """dshape (T, N, input): the flat parameter vector and the states."""
    from .ops.rnn_ops import rnn_param_size

    num_layers = int(attrs["num_layers"])
    state_size = int(attrs["state_size"])
    bidir = bool(attrs.get("bidirectional", False))
    state = (num_layers * (2 if bidir else 1), dshape[1], state_size)
    return {"parameters": (rnn_param_size(num_layers, state_size, dshape[2],
                                          attrs.get("mode", "lstm"),
                                          bidir),),
            "state": state, "state_cell": state}


def _softmax_out_shapes(attrs, dshape):
    if attrs.get("multi_output", False):
        return {"label": (dshape[0],) + tuple(dshape[2:])}
    return {"label": (dshape[0],)}


# Shape rules for auto-created params given the data shape (reference:
# each op's InferShape): fn(attrs, dshape) -> {param: shape}.
_PARAM_SHAPE_RULES = {
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "Deconvolution": _deconv_shapes,
    "BatchNorm": _bn_shapes,
    "LayerNorm": _ln_shapes,
    "InstanceNorm": _in_shapes,
    "Embedding": _embedding_shapes,
    "RNN": _rnn_shapes,
    "SoftmaxOutput": _softmax_out_shapes,
    "LinearRegressionOutput": _regression_shapes,
    "LogisticRegressionOutput": _regression_shapes,
    "MAERegressionOutput": _regression_shapes,
    # int8 variants share their float32 op's parameter geometry
    "_contrib_quantized_conv": _conv_shapes,
    "_contrib_quantized_fully_connected": _fc_shapes,
}

# Ops whose output count depends on attrs (mxnet_tpu/symbol.py:640-647).
_NUM_OUTPUT_RULES = {
    "split": lambda a: int(a.get("num_outputs", 1)),
    "SliceChannel": lambda a: int(a.get("num_outputs", 1)),
    "slice_channel": lambda a: int(a.get("num_outputs", 1)),
    "RNN": lambda a: (3 if a.get("mode", "lstm") == "lstm" else 2)
    if a.get("state_outputs") else 1,
    "LayerNorm": lambda a: 3 if a.get("output_mean_var") else 1,
    "layer_norm": lambda a: 3 if a.get("output_mean_var") else 1,
    "topk": lambda a: 2 if a.get("ret_typ") == "both" else 1,
}


def _op(op_name):
    """The registered operator (AttributeError for an unknown name)."""
    return _registry.get(op_name)


def _auto_name(hint):
    """Auto names route through the NameManager stack, so
    ``with mx.name.Prefix('net_'):`` scopes compose."""
    from .name import current_manager

    return current_manager().get(None, hint)


class Symbol:
    """A node in the symbolic graph (reference symbol.py:Symbol)."""

    _uid_counter = [0]

    def __init__(self, op, attrs=None, inputs=None, name=None, is_aux=False,
                 out_index=None, num_outputs=1, uid=None):
        self._op = op  # None => variable; "_group" => output group
        self._attrs = dict(attrs or {})
        self._inputs = list(inputs or [])
        self._name = name
        self._is_aux = is_aux
        self._out_index = out_index
        self._num_outputs = num_outputs
        # Output views (node[i]) share their base node's uid, so caches
        # keyed by uid treat them as one computation.
        if uid is None:
            Symbol._uid_counter[0] += 1
            uid = Symbol._uid_counter[0]
        self._uid = uid

    # -- identity -------------------------------------------------------------

    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attrs.get("__%s__" % key)

    def _set_attr(self, **kwargs):
        for k, v in kwargs.items():
            self._attrs["__%s__" % k] = v

    def attr_dict(self):
        """Per-node user attributes, dunder keys kept (reference
        symbol.py:attr_dict)."""
        out = {}
        for node in self._topo():
            d = {k: v for k, v in node._attrs.items()
                 if k.startswith("__") and k.endswith("__")}
            if d and node._name:
                out[node._name] = d
        return out

    def __repr__(self):
        if self._op is None:
            return "<Symbol variable %s>" % self._name
        return "<Symbol %s>" % (self._name or self._op)

    # -- graph traversal ------------------------------------------------------

    def _topo(self):
        seen = set()
        order = []

        def visit(node):
            if node._uid in seen:
                return
            seen.add(node._uid)
            for i in node._inputs:
                visit(i)
            order.append(node)

        visit(self)
        return order

    def list_arguments(self):
        """Topo-ordered input variable names (reference
        symbol.py:list_arguments)."""
        return [n._name for n in self._topo()
                if n._op is None and not n._is_aux]

    def list_auxiliary_states(self):
        return [n._name for n in self._topo() if n._op is None and n._is_aux]

    def list_outputs(self):
        if self._op == "_group":
            out = []
            for s in self._inputs:
                out.extend(s.list_outputs())
            return out
        base = self._name or self._op
        if self._num_outputs == 1 or self._out_index is not None:
            return ["%s_output" % base]
        return ["%s_output%d" % (base, i) for i in range(self._num_outputs)]

    def get_internals(self):
        """All nodes as a group (reference symbol.py:get_internals)."""
        return Group([n for n in self._topo() if n._op != "_group"])

    def __getitem__(self, index):
        if self._op == "_group":
            if isinstance(index, str):
                for s in self._inputs:
                    if index in s.list_outputs() or s._name == index:
                        return s
                raise ValueError("Cannot find output %r" % index)
            return self._inputs[index]
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(
                self._num_outputs))]
        if isinstance(index, int):
            if self._num_outputs == 1:
                if index != 0:
                    raise IndexError(index)
                return self
            return Symbol(self._op, self._attrs, self._inputs, self._name,
                          out_index=index, num_outputs=self._num_outputs,
                          uid=self._uid)
        raise TypeError(index)

    def __len__(self):
        if self._op == "_group":
            return len(self._inputs)
        if self._out_index is not None:
            raise TypeError("single-output Symbol has no len()")
        return self._num_outputs

    def __iter__(self):
        if self._op == "_group":
            return iter(self._inputs)
        if self._num_outputs == 1 or self._out_index is not None:
            raise TypeError("cannot iterate a single-output Symbol")
        return (self[i] for i in range(self._num_outputs))

    @property
    def outputs(self):
        if self._op == "_group":
            return list(self._inputs)
        return [self]

    # -- composition: operators -----------------------------------------------

    def __add__(self, other):
        return _invoke_sym("_plus", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _invoke_sym("_minus", self, other)

    def __rsub__(self, other):
        return _invoke_sym("_rminus", self, other)

    def __mul__(self, other):
        return _invoke_sym("_mul", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _invoke_sym("_div", self, other)

    def __rtruediv__(self, other):
        return _invoke_sym("_rdiv", self, other)

    def __pow__(self, other):
        return _invoke_sym("_power", self, other)

    def __neg__(self):
        return self.__mul__(-1.0)

    # Comparisons compose the broadcast/scalar logic ops; __eq__ stays
    # Python identity, as in the reference, so symbols are dict-safe.
    def __lt__(self, other):
        return _invoke_cmp("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _invoke_cmp("broadcast_lesser_equal", "_lesser_equal_scalar",
                           self, other)

    def __gt__(self, other):
        return _invoke_cmp("broadcast_greater", "_greater_scalar", self,
                           other)

    def __ge__(self, other):
        return _invoke_cmp("broadcast_greater_equal",
                           "_greater_equal_scalar", self, other)

    # -- shape/type inference -------------------------------------------------

    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from some input shapes
        (reference symbol.py:infer_shape), ordered like list_arguments(),
        list_outputs() and list_auxiliary_states()."""
        known = dict(kwargs)
        if args:
            for name, shape in zip(self.list_arguments(), args):
                if shape is not None:
                    known[name] = shape
        shapes = self._infer_all_shapes(known)
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes[("out", s._uid, s._out_index or 0)]
                      for s in self.outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    def _infer_all_shapes(self, known):
        """Forward propagation: auto-parameter shapes from the rule
        table, every op's outputs by running it on ``meta`` tensors."""
        shapes = {k: tuple(v) for k, v in known.items()}

        def shape_of(inp):
            if inp._op is None:
                return shapes.get(inp._name)
            return shapes.get(("out", inp._uid, inp._out_index or 0))

        for node in self._topo():
            if node._op is None or node._op == "_group":
                continue
            op_name = node._attrs.get("_op_name", node._op)
            rule = _PARAM_SHAPE_RULES.get(op_name)
            if rule is not None and node._inputs:
                dshape = shape_of(node._inputs[0])
                if dshape is not None:
                    rules = list(rule(node._clean_attrs(),
                                      tuple(dshape)).items())
                    params = node._inputs[1:]
                    for k, inp in enumerate(params):
                        if inp._op is not None or not inp._name:
                            continue
                        # By name, as the JAX package matches; else by
                        # position, which names like gluon's
                        # "<bn>_running_mean" need.
                        got = [ps for pn, ps in rules
                               if inp._name.endswith("_" + pn)
                               or inp._name == pn]
                        if not got and len(params) == len(rules):
                            got = [rules[k][1]]
                        if got:
                            shapes.setdefault(inp._name, got[0])
            if node._op == "_subgraph":
                # A partitioned fragment (subgraph.py): recurse with the
                # known external shapes; rule shapes found inside flow
                # back to the outer variables.
                sub_known = {}
                for nm, inp in zip(node._sub_arg_names, node._inputs):
                    s = shape_of(inp)
                    if s is not None:
                        sub_known[nm] = tuple(s)
                sub = node._sub_sym._infer_all_shapes(sub_known)
                for nm, inp in zip(node._sub_arg_names, node._inputs):
                    if inp._op is None and nm in sub:
                        shapes.setdefault(inp._name, tuple(sub[nm]))
                for oi, o in enumerate(node._sub_sym.outputs):
                    shapes[("out", node._uid, oi)] = tuple(
                        sub[("out", o._uid, o._out_index or 0)])
                continue
            # An op's own shape rule (registry.Operator.infer_shape)
            # before a run on meta tensors.
            shape_rule = getattr(_registry.OP_REGISTRY.get(op_name),
                                 "infer_shape", None)
            if shape_rule is not None:
                try:
                    got_in, got_out = shape_rule(
                        node._clean_attrs(),
                        [shape_of(i) for i in node._inputs])
                except Exception as e:  # the user's rule failed
                    raise MXNetError("infer_shape failed at %s: %s"
                                     % (node._name or op_name, e)) from None
                for inp, s in zip(node._inputs, got_in):
                    if inp._op is None and inp._name and s is not None:
                        shapes.setdefault(inp._name, tuple(s))
                for i, s in enumerate(got_out):
                    shapes[("out", node._uid, i)] = tuple(s)
                continue
            in_shapes = []
            for inp in node._inputs:
                s = shape_of(inp)
                if s is None:
                    raise MXNetError(
                        "infer_shape: missing input shapes for node %s (%s)"
                        % (node._name or op_name, op_name))
                in_shapes.append(tuple(s))
            op = _op(op_name)
            metas = [torch.empty(s, dtype=torch.float32, device="meta")
                     for s in in_shapes]
            attrs = node._clean_attrs()
            if op.creates:
                attrs["device"] = torch.device("meta")
            try:
                with torch.no_grad():
                    out = op.fn(*metas, **attrs)
            except Exception as e:  # any op failure is a shape error here
                raise MXNetError("infer_shape failed at %s: %s"
                                 % (node._name or op_name, e)) from None
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                shapes[("out", node._uid, i)] = tuple(o.shape)
        return shapes

    def infer_type(self, **kwargs):
        """All float32 (reference infer_type; dtypes are per executor)."""
        arg_types = [np.float32 for _ in self.list_arguments()]
        out_types = [np.float32 for _ in self.outputs]
        aux_types = [np.float32 for _ in self.list_auxiliary_states()]
        return arg_types, out_types, aux_types

    def _clean_attrs(self):
        return {k: v for k, v in self._attrs.items()
                if not (k.startswith("__") and k.endswith("__"))
                and k != "_op_name"}

    # -- serialization --------------------------------------------------------

    def tojson(self):
        """JSON graph in the JAX package's format (reference
        symbol.py:tojson): nodes with op/name/attrs/input indices."""
        order = [n for n in self._topo() if n._op != "_group"]
        index = {n._uid: i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            nodes.append({
                "op": n._op or "null",
                "name": n._name,
                "attrs": _jsonify_attrs(n._attrs),
                "inputs": [[index[i._uid], i._out_index or 0]
                           for i in n._inputs],
                "is_aux": n._is_aux,
                "out_index": n._out_index,
                "num_outputs": n._num_outputs,
            })
        heads = [[index[s._uid], s._out_index or 0] for s in self.outputs]
        return json.dumps({"nodes": nodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        """Write tojson() atomically: a crash never leaves a truncated
        graph file beside valid params."""
        from .base import atomic_write

        with atomic_write(fname, "w") as f:
            f.write(self.tojson())

    # -- execution ------------------------------------------------------------

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Allocate zero arrays of the inferred shapes and bind
        (reference symbol.py:simple_bind). ``type_dict`` gives an
        argument's or aux state's dtype by name (default float32)."""
        from . import ndarray as nd
        from .executor import Executor

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if any(s is None for s in arg_shapes):
            raise MXNetError("simple_bind: could not infer all shapes "
                             "from %s" % kwargs)
        types = dict(type_dict or {})

        def zeros(names, shapes):
            return [nd.zeros(s, ctx=ctx, dtype=types.get(n))
                    for n, s in zip(names, shapes)]

        arg_names = self.list_arguments()
        args = zeros(arg_names, arg_shapes)
        grad_arrays = None
        if grad_req != "null":
            grad_arrays = zeros(arg_names, arg_shapes)
        aux = zeros(self.list_auxiliary_states(), aux_shapes)
        return Executor(self, ctx, args, grad_arrays, grad_req, aux,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    def eval(self, ctx=None, **kwargs):
        """One forward with kwargs as the argument arrays (reference
        symbol.py:eval)."""
        return self.bind(ctx, args=kwargs, grad_req="null").forward(
            is_train=False)


def _jsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (np.ndarray, np.generic)):
            v = v.tolist()
        elif isinstance(v, tuple):
            v = list(v)
        elif not isinstance(v, (str, int, float, bool, list, dict,
                                type(None))):
            v = str(v)  # last resort: keep the graph serializable
        out[k] = v
    return out


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (reference symbol.py:var)."""
    from .attribute import current_attrs

    s = Symbol(None, name=name)
    scoped = current_attrs()
    if scoped:
        s._attrs.update({"__%s__" % k: v for k, v in scoped.items()})
    if attr:
        s._attrs.update({"__%s__" % k: v for k, v in attr.items()})
    if shape is not None:
        s._attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        s._attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        s._attrs["__wd_mult__"] = wd_mult
    if init is not None:
        # The JSON spec, not the object, so tojson() stays serializable.
        s._attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if dtype is not None:
        s._attrs["__dtype__"] = dtype if isinstance(dtype, str) \
            else str(np.dtype(dtype).name)
    if stype is not None:
        s._attrs["__storage_type__"] = stype
    return s


var = Variable


def Group(symbols):
    """Group outputs (reference symbol.py:Group)."""
    flat = []
    for s in symbols:
        flat.extend(s.outputs)
    return Symbol("_group", inputs=flat)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for nd_ in data["nodes"]:
        op = None if nd_["op"] == "null" else nd_["op"]
        inputs = [nodes[i][oi] if nodes[i]._num_outputs > 1 and oi
                  else nodes[i] for i, oi in nd_["inputs"]]
        attrs = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in nd_.get("attrs", {}).items()}
        nodes.append(Symbol(op, attrs=attrs, inputs=inputs,
                            name=nd_.get("name"),
                            is_aux=nd_.get("is_aux", False),
                            out_index=nd_.get("out_index"),
                            num_outputs=nd_.get("num_outputs", 1)))
    heads = [nodes[i] if nodes[i]._num_outputs == 1 else nodes[i][oi]
             for i, oi in data["heads"]]
    if len(heads) == 1:
        return heads[0]
    return Group(heads)


# -- op composition ----------------------------------------------------------

def _invoke_cmp(op_name, scalar_op_name, lhs, rhs):
    if isinstance(rhs, Symbol):
        return _make_symbol_op(op_name)(lhs, rhs)
    return _make_symbol_op(scalar_op_name)(lhs, scalar=float(rhs))


_SCALAR_OPS = {"_plus": "_plus_scalar", "_minus": "_minus_scalar",
               "_rminus": "_rminus_scalar", "_mul": "_mul_scalar",
               "_div": "_div_scalar", "_rdiv": "_rdiv_scalar",
               "_power": "_power_scalar"}


def _invoke_sym(op_name, lhs, rhs):
    """Binary operator composition, scalar-aware (reference: the
    _internal _plus/_plus_scalar split)."""
    if isinstance(rhs, Symbol):
        return _make_symbol_op(op_name)(lhs, rhs)
    return _make_symbol_op(_SCALAR_OPS[op_name])(lhs, scalar=float(rhs))


_SYM_FUNC_CACHE = {}


def _num_outputs(op_name, attrs):
    rule = _NUM_OUTPUT_RULES.get(op_name)
    return rule(attrs) if rule else 1


def _scoped_attrs(attrs, attr):
    from .attribute import current_attrs

    scoped = current_attrs()
    if scoped:
        attrs.update({"__%s__" % k: v for k, v in scoped.items()})
    if attr:
        attrs.update({"__%s__" % k: v for k, v in attr.items()})
    return attrs


def _make_symbol_op(op_name):
    """The symbolic composer of a registered op: Symbols in args/kwargs
    become node inputs, scalars become attrs, missing learnable inputs
    become auto-created variables."""
    fn = _SYM_FUNC_CACHE.get(op_name)
    if fn is not None:
        return fn
    op = _op(op_name)
    try:
        sig = inspect.signature(op.fn)
        # An RNG op's generator and a creating op's device are passed
        # at run time, never composed.
        sig_params = [p for p in sig.parameters
                      if p not in ("generator", "device")]
        has_varargs = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                          for p in sig.parameters.values())
    except (TypeError, ValueError):
        sig_params = []
        has_varargs = False
    param_inputs = _OP_PARAM_INPUTS.get(op_name, [])

    def sym_op(*args, name=None, attr=None, **kwargs):
        name_ = name or _auto_name(op_name.lower().lstrip("_"))
        if has_varargs:
            # Variadic op (*arrays, **attrs): every positional Symbol is
            # an input in order; everything else is an attr.
            inputs_v = [a for a in args if isinstance(a, Symbol)]
            if len(inputs_v) != len(args):
                raise TypeError(
                    "%s: positional args must all be Symbols; pass "
                    "scalars by keyword" % op_name)
            attrs_v = {}
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    inputs_v.append(v)
                elif v is not None:
                    attrs_v[k] = v
            attrs_v["_op_name"] = op_name
            return Symbol(op_name, attrs=_scoped_attrs(attrs_v, attr),
                          inputs=inputs_v, name=name_,
                          num_outputs=_num_outputs(op_name, attrs_v))
        inputs = {}
        attrs = {}
        pos = 0
        for a in args:
            if isinstance(a, Symbol):
                # the next unfilled signature slot
                while pos < len(sig_params) and sig_params[pos] in inputs:
                    pos += 1
            pname = sig_params[pos] if pos < len(sig_params) \
                else "arg%d" % pos
            if isinstance(a, Symbol):
                inputs[pname] = a
            else:
                attrs[pname] = a
            pos += 1
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                inputs[k] = v
            elif v is not None:
                attrs[k] = v
        for pname, is_aux, skip_attr in param_inputs:
            if pname in inputs:
                # A bare variable passed into an aux slot (BatchNorm's
                # moving stats) is an auxiliary state: aux-ness comes
                # from the op signature. Mark a copy, never the caller's
                # Symbol, which other graphs may share.
                v = inputs[pname]
                if is_aux and v._op is None and not v._is_aux:
                    cp = Symbol(None, name=v._name, is_aux=True)
                    cp._attrs.update(v._attrs)
                    inputs[pname] = cp
                continue
            if skip_attr and attrs.get(skip_attr):
                continue
            inputs[pname] = Symbol(None, name="%s_%s" % (name_, pname),
                                   is_aux=is_aux)
        ordered = [inputs[p] for p in sig_params if p in inputs]
        extra = [v for k, v in inputs.items() if k not in sig_params]
        attrs["_op_name"] = op_name
        return Symbol(op_name, attrs=_scoped_attrs(attrs, attr),
                      inputs=ordered + extra, name=name_,
                      num_outputs=_num_outputs(op_name, attrs))

    sym_op.__name__ = op_name
    _SYM_FUNC_CACHE[op_name] = sym_op
    return sym_op


def zeros(shape, dtype="float32", **kwargs):
    return _make_symbol_op("zeros")(shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return _make_symbol_op("ones")(shape=shape, dtype=dtype, **kwargs)


def arange(start, stop=None, step=1.0, **kwargs):
    return _make_symbol_op("arange")(start=start, stop=stop, step=step,
                                     **kwargs)


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name == "contrib":
        from . import symbol_contrib

        return symbol_contrib
    return _make_symbol_op(name)
