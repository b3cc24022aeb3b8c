"""Unfused recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py:57-547`` (reference
python/mxnet/gluon/rnn/rnn_cell.py: RecurrentCell, RNNCell, LSTMCell,
GRUCell, the sequential cells, DropoutCell, ZoneoutCell, ResidualCell,
BidirectionalCell). Cells are HybridBlocks; ``unroll`` is a Python loop
of step calls (each through the cell's CachedOp once hybridized), with
``valid_length`` masking the padded steps (SequenceMask) and taking each
sequence's state at its true last step (SequenceLast). Gate order is the
fused op's (ops/rnn_ops.py): LSTM [i, f, g, o], GRU [r, z, n], so a
fused layer and its ``unfuse()`` cells compute the same function. The
begin states of an unroll live on the inputs' device.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Normalize `inputs` to a list of (N, C) steps or a merged tensor.
    Returns (inputs, axis, batch_size). (reference rnn_cell.py:_format_sequence)."""
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[batch_axis - 1 if batch_axis > axis
                                     else batch_axis]
        if merge:
            inputs = nd.stack(*inputs, axis=axis)
        return inputs, axis, batch_size
    batch_size = inputs.shape[batch_axis]
    if not merge:
        steps = nd.split(inputs, num_outputs=inputs.shape[axis], axis=axis)
        if not isinstance(steps, (list, tuple)):
            steps = [steps]
        squeezed = [s.reshape(tuple(d for i, d in enumerate(s.shape)
                                    if i != axis)) for s in steps]
        return squeezed, axis, batch_size
    return inputs, axis, batch_size


class RecurrentCell(Block):
    """Base class (reference rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference rnn_cell.py:begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **{**info, **kwargs}))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell `length` steps (reference rnn_cell.py:unroll):
        one step call per step."""
        self.reset()
        steps, axis, batch_size = _format_sequence(length, inputs, layout,
                                                   False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=steps[0].context)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # Final state of each sequence is at its true last step, and
            # padded steps are zero-masked (reference rnn_cell.py:unroll
            # valid_length handling).
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            stacked = nd.SequenceMask(
                nd.stack(*outputs, axis=0), sequence_length=valid_length,
                use_sequence_length=True, axis=0)  # (T, N, C)
            if merge_outputs is False:
                outputs = list(nd.split(stacked, num_outputs=length,
                                        axis=0, squeeze_axis=True))
            elif layout == "NTC":
                outputs = nd.transpose(stacked, axes=(1, 0, 2))
            else:
                outputs = stacked
            return outputs, states
        if merge_outputs is None or merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable cell (reference rnn_cell.py:HybridRecurrentCell)."""

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W_i x + b_i + W_h h + b_h)
    (reference rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, g, o] (reference rnn_cell.py:LSTMCell)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        in_gate, forget_gate, in_trans, out_gate = F.split(
            gates, num_outputs=4, axis=-1)
        in_gate = F.Activation(in_gate, act_type="sigmoid")
        forget_gate = F.Activation(forget_gate, act_type="sigmoid")
        in_trans = F.Activation(in_trans, act_type="tanh")
        out_gate = F.Activation(out_gate, act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, cuDNN equations, gate order [r, z, n]
    (reference rnn_cell.py:GRUCell)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=-1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied per step (reference rnn_cell.py:
    SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        # Layer by layer: each cell unrolls the whole sequence in turn.
        self.reset()
        num_cells = len(self._children)
        if begin_state is None:
            steps, _, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=steps[0].context)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states


class HybridSequentialRNNCell(SequentialRNNCell):
    """(reference rnn_cell.py:HybridSequentialRNNCell)."""


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step input (reference rnn_cell.py:DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Wraps a cell, reusing its parameters (reference rnn_cell.py:
    ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell
        self.register_child(base_cell)

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:ZoneoutCell;
    Krueger et al. 2016): randomly preserve previous states."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Apply ZoneoutCell to the cells underneath instead."
        self._zoneout_outputs = zoneout_outputs  # before super: _alias uses it
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self._zoneout_outputs, self._zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the input to the output (reference rnn_cell.py:ResidualCell)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=True, valid_length=valid_length)
        self.base_cell._modified = True
        merged, axis, _ = _format_sequence(length, inputs, layout, True)
        if valid_length is not None:
            # Keep the zero-padding invariant: mask the inputs too before
            # the residual add (reference rnn_cell.py:ResidualCell.unroll).
            vl_axis = 0 if axis == 0 else 1
            if vl_axis == 1:
                merged = nd.transpose(merged, axes=(1, 0, 2))
            merged = nd.SequenceMask(merged, sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
            if vl_axis == 1:
                merged = nd.transpose(merged, axes=(1, 0, 2))
        outputs = outputs + merged
        if merge_outputs is False:
            outputs = [o.reshape(tuple(d for i, d in enumerate(o.shape)
                                       if i != axis))
                       for o in nd.split(outputs, num_outputs=length,
                                         axis=axis)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Runs two cells over the sequence in opposite directions
    (reference rnn_cell.py:BidirectionalCell). Step-call is undefined —
    only unroll works."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis, batch_size = _format_sequence(length, inputs, layout,
                                                   False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=steps[0].context)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        step_layout = "TNC" if axis == 0 else "NTC"
        l_outputs, l_states = l_cell.unroll(
            length, inputs=steps, begin_state=begin_state[:n_l],
            layout=step_layout, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is None:
            rev_inputs = list(reversed(steps))
        else:
            # Reverse only the VALID portion per sequence so the reverse
            # cell never consumes padding before real tokens (reference
            # uses SequenceReverse(sequence_length=valid_length)).
            rev = nd.SequenceReverse(nd.stack(*steps, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
            rev_inputs = list(nd.split(rev, num_outputs=length, axis=0,
                                       squeeze_axis=True))
        r_outputs, r_states = r_cell.unroll(
            length, inputs=rev_inputs, begin_state=begin_state[n_l:],
            layout=step_layout, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            rev_out = nd.SequenceReverse(nd.stack(*r_outputs, axis=0),
                                         sequence_length=valid_length,
                                         use_sequence_length=True, axis=0)
            r_outputs = list(nd.split(rev_out, num_outputs=length, axis=0,
                                      squeeze_axis=True))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs is None or merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
