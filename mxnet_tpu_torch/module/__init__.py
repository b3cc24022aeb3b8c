"""mx.mod — symbolic training modules.

Counterpart of ``mxnet_tpu/module/`` (reference: python/mxnet/module/).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule"]
