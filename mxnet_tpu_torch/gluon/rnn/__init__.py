"""gluon.rnn: recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn/``; reference python/mxnet/gluon/rnn/)."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, HybridSequentialRNNCell,
                       DropoutCell, ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "RNN", "LSTM", "GRU"]
