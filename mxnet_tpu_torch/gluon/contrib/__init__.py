"""gluon.contrib — experimental Gluon layers, cells, samplers and losses.

Counterpart of ``mxnet_tpu/gluon/contrib/`` (reference:
python/mxnet/gluon/contrib/: nn basic layers, rnn cells incl.
VariationalDropout and convolutional RNN cells, data samplers).
"""
from . import nn
from . import rnn
from . import data
from . import loss

__all__ = ["nn", "rnn", "data", "loss"]
