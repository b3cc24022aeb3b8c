"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/``): the vision
models and the local pretrained-weight store."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
