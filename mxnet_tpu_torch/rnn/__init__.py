"""`mx.rnn`, the legacy symbolic RNN API (counterpart of
``mxnet_tpu/rnn/``; reference python/mxnet/rnn/)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ResidualCell, ZoneoutCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ResidualCell", "ZoneoutCell",
           "BucketSentenceIter", "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
