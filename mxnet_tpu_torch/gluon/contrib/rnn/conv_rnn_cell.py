"""Convolutional recurrent cells (ConvRNN / ConvLSTM / ConvGRU, 1D/2D/3D).

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``
(reference: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py; Shi et al.
2015 "Convolutional LSTM Network"). The input-to-hidden and
hidden-to-hidden transforms are convolutions instead of dense layers;
state shape is (batch, hidden_channels, *spatial). Both convolutions are
the port's ``Convolution`` op (cuDNN on a card); an unroll is the base
cell's Python loop of step calls.
"""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    assert len(v) == n, "%s must have %d elements, got %s" % (name, n, v)
    return v


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared machinery for conv recurrent cells (reference
    conv_rnn_cell.py:_BaseConvRNNCell)."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, conv_layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)   # (C, *spatial)
        self._channels = hidden_channels
        self._dims = dims
        self._i2h_kernel = _tup(i2h_kernel, dims, "i2h_kernel")
        self._h2h_kernel = _tup(h2h_kernel, dims, "h2h_kernel")
        assert all(k % 2 == 1 for k in self._h2h_kernel), \
            "h2h_kernel must be odd so the state keeps its spatial shape"
        self._i2h_pad = _tup(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tup(i2h_dilate, dims, "i2h_dilate")
        self._h2h_dilate = _tup(h2h_dilate, dims, "h2h_dilate")
        # "same" padding for the recurrent conv
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        self._activation = activation

        in_c = self._input_shape[0]
        self._state_shape = self._compute_state_shape()
        g = self._num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g * hidden_channels, in_c)
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g * hidden_channels, hidden_channels)
            + self._h2h_kernel, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def _compute_state_shape(self):
        spatial = self._input_shape[1:]
        out = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, k, d in zip(spatial, self._i2h_pad, self._i2h_kernel,
                                  self._i2h_dilate))
        return (self._channels,) + out

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[3 - self._dims:]}] \
            * self._num_states

    _num_states = 1

    def _convs(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        g = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            stride=(1,) * self._dims,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            num_filter=g * self._channels)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            stride=(1,) * self._dims,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=g * self._channels)
        return i2h, h2h

    def _act(self, F, x):
        return self._get_activation(F, x, self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    """h' = act(conv(x) + conv(h))."""

    _num_gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        output = self._act(F, i2h + h2h)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    """ConvLSTM (Shi et al. 2015), gate order [i, f, g, o]."""

    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gates = i2h + h2h
        in_g, forget_g, in_t, out_g = F.split(gates, num_outputs=4, axis=1)
        in_g = F.Activation(in_g, act_type="sigmoid")
        forget_g = F.Activation(forget_g, act_type="sigmoid")
        in_t = self._act(F, in_t)
        out_g = F.Activation(out_g, act_type="sigmoid")
        next_c = forget_g * states[1] + in_g * in_t
        next_h = out_g * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """ConvGRU, gate order [r, z, n]."""

    _num_gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        new = self._act(F, i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * new + update * states[0]
        return next_h, [next_h]


def _make(base, dims, name_):
    class Cell(base):
        __doc__ = base.__doc__

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, **kwargs):
            kwargs.setdefault("dims", dims)
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, **kwargs)

    Cell.__name__ = Cell.__qualname__ = name_
    return Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
