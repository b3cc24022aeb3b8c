"""Text processing utilities: counterpart of
``mxnet_tpu/contrib/text/__init__.py`` (reference:
python/mxnet/contrib/text/__init__.py — vocab, embedding, utils)."""
from . import embedding
from . import utils
from . import vocab
from .vocab import Vocabulary

__all__ = ["embedding", "utils", "vocab", "Vocabulary"]
