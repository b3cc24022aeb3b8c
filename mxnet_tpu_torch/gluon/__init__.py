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


def __getattr__(name):
    # gluon.contrib is imported on first use, as in the JAX package
    # (mxnet_tpu/gluon/__init__.py:13).
    if name == "contrib":
        import importlib

        mod = importlib.import_module(".contrib", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(name)
