"""Contrib recurrent cells.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/contrib/rnn/rnn_cell.py: VariationalDropoutCell, Gal
& Ghahramani 2016 dropout with masks fixed across time steps; LSTMPCell,
LSTM with hidden-state projection, Sak et al. 2014). Masks are drawn
from the generator of the device the cell runs on.
"""
from __future__ import annotations

from ...rnn.rnn_cell import (HybridRecurrentCell, ModifierCell,
                             BidirectionalCell, _format_sequence)

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Apply dropout with masks sampled ONCE per sequence to the inputs,
    states, and outputs of `base_cell` (reference contrib
    rnn_cell.py:VariationalDropoutCell)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "BidirectionalCell doesn't support state dropout; apply " \
            "VariationalDropoutCell to the cells underneath instead."
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        super().__init__(base_cell)
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, F, p, like):
        # Dropout of a ones-tensor gives a 0/(1/(1-p)) mask; sampling it
        # once and reusing every step is what makes it "variational".
        return F.Dropout(F.ones_like(like), p=p)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(F, self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            # Only h, the first state, as upstream (rnn_cell.py:
            # VariationalDropoutCell.hybrid_forward); the JAX package
            # multiplies every state by h's mask, which drops an LSTM's
            # cell state too and fails where the shapes differ (LSTMP).
            if self._state_mask is None:
                self._state_mask = self._mask(F, self.drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(F, self.drop_outputs, output)
            output = output * self._output_mask
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Whole-sequence unroll: input/output dropout applies one mask
        broadcast over the time axis (`axes=(time,)`), state dropout
        rides the per-step path (reference VariationalDropoutCell.unroll).
        """
        self.reset()
        from .... import ndarray as nd

        merged, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    True)
        if self.drop_inputs:
            merged = nd.Dropout(merged, p=self.drop_inputs, axes=(axis,))
        drop_inputs, drop_outputs = self.drop_inputs, self.drop_outputs
        # Input/output dropout already applied on the merged sequence;
        # disable them on the per-step path for this unroll.
        self.drop_inputs = self.drop_outputs = 0.0
        try:
            outputs, states = super().unroll(
                length, merged, begin_state=begin_state, layout=layout,
                merge_outputs=True, valid_length=valid_length)
        finally:
            self.drop_inputs, self.drop_outputs = drop_inputs, drop_outputs
        if drop_outputs:
            outputs = nd.Dropout(outputs, p=drop_outputs, axes=(axis,))
        if merge_outputs is False:
            outputs = [outputs[i] if axis == 0 else
                       outputs[:, i] for i in range(length)]
        return outputs, states

    def __repr__(self):
        return "VariationalDropoutCell(%s, in=%.2f state=%.2f out=%.2f)" % (
            self.base_cell.name, self.drop_inputs, self.drop_states,
            self.drop_outputs)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a linear projection of the hidden state
    (reference contrib rnn_cell.py:LSTMPCell; LSTMP, Sak et al. 2014):

        r_t = P (o_t * tanh(c_t))

    so the recurrent path is `projection_size`-dim while the cell keeps
    `hidden_size` memory, which shrinks the serial h2h GEMM of every
    step.
    """

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
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
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]

    def __repr__(self):
        return "LSTMPCell(%d -> %d -> %d)" % (
            self._input_size, self._hidden_size, self._projection_size)
