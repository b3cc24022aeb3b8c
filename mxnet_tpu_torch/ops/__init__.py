"""Operator library of the port: importing this package registers every
operator (counterpart of ``mxnet_tpu/ops/``)."""
from . import registry
from . import elementwise, matrix, reduce, nn, flash_attention  # noqa: F401

__all__ = ["registry"]
