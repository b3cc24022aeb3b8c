"""mx.image — image IO and augmentation (reference: python/mxnet/image/).

Counterpart of ``mxnet_tpu/image/__init__.py``. ``image/detection.py``
(the detection augmenters and ``ImageDetIter``) waits for SSD, ROADMAP
Queue 1 item 11.
"""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from . import png  # noqa: F401

__all__ = image.__all__
