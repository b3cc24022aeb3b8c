"""Legacy symbolic RNN cells.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
python/mxnet/rnn/rnn_cell.py: BaseRNNCell, RNNParams, RNNCell/LSTMCell/
GRUCell, FusedRNNCell with ``pack_weights``/``unpack_weights``,
SequentialRNNCell, BidirectionalCell, the Dropout/Modifier/Residual/
Zoneout cells). Cells compose ``mx.sym`` graphs; ``unroll`` emits the
whole sequence's graph, which an Executor runs. ``FusedRNNCell`` emits
one ``sym.RNN`` node (ops/rnn_ops.py).

With no ``func``, ``begin_state`` gives zero states derived from the
input symbol (``slice_axis``, ``zeros_like``, ``broadcast_axis``), so
shape inference needs no (0, H)-shaped placeholder, as in the JAX
package.
"""
from __future__ import annotations

from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ResidualCell", "ZoneoutCell"]


class RNNParams:
    """Container for cell weights (reference rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract symbolic cell (reference rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def __call__(self, inputs, states):
        raise NotImplementedError

    def begin_state(self, func=None, init_sym=None, **kwargs):
        """Initial state symbols.

        With no `func`, states are zeros shaped off `init_sym` (set
        during unroll to the first input step). With a `func` (e.g.
        sym.Variable), mirrors the reference's explicit-state pattern."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%02d" % (self._prefix, self._init_counter)
            if func is not None:
                info = dict(info)
                shape = info.pop("shape", None)
                state = func(name=name, shape=shape, **kwargs) \
                    if func is symbol.Variable else func(shape, **kwargs)
            else:
                assert init_sym is not None, \
                    "begin_state outside unroll requires func= or init_sym="
                state = _zeros_from(init_sym, info["shape"])
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Fused flat vector -> per-gate dict (reference
        rnn_cell.py:unpack_weights). Step cells store unfused already."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """(reference rnn_cell.py:BaseRNNCell.unroll)."""
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(init_sym=inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs is None or
                                         merge_outputs, axis)
        return outputs, states


def _zeros_from(ref_sym, shape):
    """(N, H) zeros derived from a (N, C) step symbol: slice one input
    column, zero it, broadcast to H."""
    col = symbol.slice_axis(ref_sym, axis=-1, begin=0, end=1)
    z = symbol.zeros_like(col)
    if shape[-1] != 1:
        z = symbol.broadcast_axis(z, axis=len(shape) - 1, size=shape[-1])
    return z


def _normalize_sequence(length, inputs, layout, merge, in_axis=None):
    """list-of-steps <-> merged tensor (reference
    rnn_cell.py:_normalize_sequence)."""
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if not merge:
            steps = symbol.split(inputs, num_outputs=length, axis=axis,
                                 squeeze_axis=True)
            if isinstance(steps, (list, tuple)):
                return list(steps), axis
            # multi-output node: index out each step symbol
            return [steps[i] for i in range(length)] if length > 1 \
                else [steps], axis
        return inputs, axis
    # list of step symbols
    if merge:
        merged = symbol.stack(*inputs, axis=axis)
        return merged, axis
    return list(inputs), axis


class RNNCell(BaseRNNCell):
    """Elman cell (reference rnn_cell.py:RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM, gates [i, f, g, o] (reference rnn_cell.py:LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from .. import initializer

        self._iB = self.params.get(
            "i2h_bias", init=initializer.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slices = symbol.split(gates, num_outputs=4, axis=-1,
                              name="%sslice" % name)
        in_gate = symbol.Activation(slices[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slices[1], act_type="sigmoid")
        in_transform = symbol.Activation(slices[2], act_type="tanh")
        out_gate = symbol.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU (reference rnn_cell.py:GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = symbol.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = symbol.split(h2h, num_outputs=3, axis=-1)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_n + reset_gate * h2h_n,
                                       act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell emitting one sym.RNN node (reference
    rnn_cell.py:FusedRNNCell — the cuDNN path; here the port's RNN op,
    ops/rnn_ops.py)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = 2 if bidirectional else 1
        from .. import initializer

        self._parameter = self.params.get(
            "parameters", init=initializer.FusedRNN(
                None, num_hidden=num_hidden, num_layers=num_layers,
                mode=mode, bidirectional=bidirectional,
                forget_bias=forget_bias))

    @property
    def state_info(self):
        b = self._num_layers * self._directions
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def begin_state(self, func=None, init_sym=None, **kwargs):
        if func is not None or init_sym is None:
            return super().begin_state(func=func, init_sym=init_sym,
                                       **kwargs)
        # (L*D, N, H) zeros from the (T, N, C) input symbol.
        states = []
        for info in self.state_info:
            col = symbol.slice_axis(init_sym, axis=-1, begin=0, end=1)
            first = symbol.slice_axis(col, axis=0, begin=0, end=1)
            z = symbol.zeros_like(first)  # (1, N, 1)
            z = symbol.broadcast_axis(z, axis=0, size=info["shape"][0])
            z = symbol.broadcast_axis(z, axis=2, size=self._num_hidden)
            states.append(z)
        return states

    def unpack_weights(self, args):
        """Split the fused vector into per-gate arrays named like unfused
        cells (reference rnn_cell.py:FusedRNNCell.unpack_weights)."""
        from .. import ndarray as nd
        from ..ops.rnn_ops import rnn_param_layout

        args = dict(args)
        vec = args.pop(self._prefix + "parameters")
        flat = vec.asnumpy().reshape(-1)
        in_sz = self._input_size_hint(flat)
        for name, shape, off in rnn_param_layout(
                self._num_layers, self._num_hidden, in_sz, self._mode,
                self._bidirectional):
            import numpy as np

            n = int(np.prod(shape))
            args[self._prefix + name] = nd.array(
                flat[off:off + n].reshape(shape))
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd
        from ..ops.rnn_ops import rnn_param_layout, rnn_param_size
        import numpy as np

        args = dict(args)
        w0 = args[self._prefix + "l0_i2h_weight"]
        in_sz = w0.shape[1]
        total = rnn_param_size(self._num_layers, self._num_hidden, in_sz,
                               self._mode, self._bidirectional)
        flat = np.zeros((total,), np.float32)
        for name, shape, off in rnn_param_layout(
                self._num_layers, self._num_hidden, in_sz, self._mode,
                self._bidirectional):
            n = int(np.prod(shape))
            flat[off:off + n] = args.pop(
                self._prefix + name).asnumpy().reshape(-1)
        args[self._prefix + "parameters"] = nd.array(flat)
        return args

    def _input_size_hint(self, flat):
        from ..ops.rnn_ops import rnn_infer_input_size

        return rnn_infer_input_size(flat.shape[0], self._num_layers,
                                    self._num_hidden, self._mode,
                                    self._bidirectional)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, True)
        if layout == "NTC":
            inputs = symbol.transpose(inputs, axes=(1, 0, 2))
        if begin_state is None:
            states = self.begin_state(init_sym=inputs)
        else:
            states = begin_state
        rnn = symbol.RNN(inputs, self._parameter, *states,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         name="%srnn" % self._prefix)
        if self._get_next_state:
            outputs = rnn[0]
            states = list(rnn[1:])
        else:
            outputs, states = rnn, []
        if layout == "NTC":
            outputs = symbol.transpose(outputs, axes=(1, 0, 2))
        if merge_outputs is False:
            axis = layout.find("T")
            outputs = list(symbol.split(outputs, num_outputs=length,
                                        axis=axis, squeeze_axis=True))
        return outputs, states

    def unfuse(self):
        """(reference rnn_cell.py:FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" %
                                      (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """(reference rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, func=None, init_sym=None, **kwargs):
        assert not self._modified
        return sum([c.begin_state(func=func, init_sym=init_sym, **kwargs)
                    for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        if begin_state is not None:
            assert len(begin_state) == len(self.state_info)
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n] if begin_state is not None else None
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """(reference rnn_cell.py:DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """(reference rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, init_sym=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, init_sym=init_sym,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ResidualCell(ModifierCell):
    """(reference rnn_cell.py:ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class ZoneoutCell(ModifierCell):
    """(reference rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Use unfuse() first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Apply ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None
        if hasattr(self, "base_cell"):
            self.base_cell.reset()

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0.0 \
            else next_output
        states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self.prev_output = output
        return output, states


class BidirectionalCell(BaseRNNCell):
    """(reference rnn_cell.py:BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, func=None, init_sym=None, **kwargs):
        assert not self._modified
        return sum([c.begin_state(func=func, init_sym=init_sym, **kwargs)
                    for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(init_sym=inputs[0])
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        outputs = [symbol.concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in
                   enumerate(zip(l_outputs, reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs is None or
                                         merge_outputs, axis)
        return outputs, l_states + r_states
