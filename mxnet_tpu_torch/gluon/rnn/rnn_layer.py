"""Fused recurrent layers: RNN, LSTM and GRU.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
python/mxnet/gluon/rnn/rnn_layer.py:234-433, ``unfuse()`` :116). The
parameters are registered one by one under the reference's names
(``l0_i2h_weight``, ``r0_i2h_weight``, ...), so checkpoints match, and
concatenated at each forward into the fused op's flat vector
(ops/rnn_ops.py). ``unfuse()`` returns the equivalent stack of cells,
sharing these parameters.
"""
from __future__ import annotations

from ... import ndarray as nd
from ...ops import rnn_ops
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused layer (reference rnn_layer.py:_RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC', 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._layout_entries = rnn_ops.rnn_param_layout(
            num_layers, hidden_size, input_size, mode, bidirectional)
        for name, shape, _ in self._layout_entries:
            if name.endswith("weight"):
                init = i2h_weight_initializer if "i2h" in name \
                    else h2h_weight_initializer
            else:
                init = i2h_bias_initializer if "i2h" in name \
                    else h2h_bias_initializer
            p = self.params.get(name, shape=shape, init=init,
                                allow_deferred_init=True)
            setattr(self, name, p)

    def _gates(self):
        return rnn_ops._NGATES[self._mode]

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "%s -> %s" % (shape[1] if shape[1] else None,
                                shape[0] // self._gates())
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, inputs, *args):
        in_sz = inputs.shape[2] if self._layout == "TNC" else inputs.shape[-1]
        self._input_size = in_sz
        self._layout_entries = rnn_ops.rnn_param_layout(
            self._num_layers, self._hidden_size, in_sz, self._mode,
            self._dir == 2)
        for name, shape, _ in self._layout_entries:
            getattr(self, name).shape = shape

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """(reference rnn_layer.py:begin_state)."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **{**info, **kwargs}))
        return states

    def unfuse(self):
        """Equivalent stack of unfused cells (reference
        rnn_layer.py:116)."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        from ..parameter import ParameterDict

        def donor(sub):
            # A dict whose PREFIX is the cell's full name-path and whose
            # entries are the fused layer's parameters: donor-prefix
            # sharing then resolves "<prefix><sub>i2h_weight" to the SAME
            # Parameter the fused path reads (the reference achieves this
            # via name_scope nesting, rnn_layer.py:116).
            d = ParameterDict(self.prefix + sub)
            for k, v in self.params.items():
                d._params[k] = v
            return d

        stack = rnn_cell.HybridSequentialRNNCell(prefix=self.prefix,
                                                 params=self.params)
        for i in range(self._num_layers):
            if self._dir == 2:
                stack.add(rnn_cell.BidirectionalCell(
                    get_cell(params=donor("l%d_" % i)),
                    get_cell(params=donor("r%d_" % i))))
            else:
                stack.add(get_cell(params=donor("l%d_" % i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(rnn_cell.DropoutCell(self._dropout))
        return stack

    def forward(self, inputs, states=None):
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch, ctx=inputs.context)
        if isinstance(states, nd.ndarray.NDArray):
            states = [states]
        out = super().forward(inputs, states)
        # out = (output, [states...])
        return out[0] if skip_states else out

    def hybrid_forward(self, F, inputs, states, **params):
        if self._layout == "NTC":
            inputs = F.transpose(inputs, axes=(1, 0, 2))
        flat = F.concat(*[F.reshape(params[name], shape=(-1,))
                          for name, _, _ in self._layout_entries], dim=0)
        rnn_args = [inputs, flat] + list(states)
        out = F.RNN(*rnn_args, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        out = list(out)
        output, out_states = out[0], out[1:]
        if self._layout == "NTC":
            output = F.transpose(output, axes=(1, 0, 2))
        return output, out_states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh/relu (reference
    rnn_layer.py:RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
