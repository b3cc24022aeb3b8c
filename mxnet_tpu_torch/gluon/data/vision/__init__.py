"""Vision datasets and transforms (reference:
python/mxnet/gluon/data/vision/).

Counterpart of ``mxnet_tpu/gluon/data/vision/__init__.py``."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
