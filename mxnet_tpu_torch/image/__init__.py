"""mx.image — image IO and augmentation (reference: python/mxnet/image/).

Counterpart of ``mxnet_tpu/image/__init__.py``: ``image/image.py``
and ``image/detection.py`` (the detection augmenters and
``CreateDetAugmenter``; neither package has an ``ImageDetIter``).
"""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from . import png  # noqa: F401
from .detection import *  # noqa: F401,F403

__all__ = image.__all__
