"""Gluon — the imperative-first user API (counterpart of
``mxnet_tpu/gluon/``)."""
from . import parameter
from .parameter import Parameter, Constant, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import rnn
from . import utils
from . import loss
from . import model_zoo
from . import trainer
from .trainer import Trainer
from . import data
