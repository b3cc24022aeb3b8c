"""Operator library of the port: importing this package registers every
operator (counterpart of ``mxnet_tpu/ops/``)."""
from . import registry
from . import (elementwise, matrix, reduce, nn, optimizer_ops,  # noqa: F401
               flash_attention, sequence, rnn_ops, control_flow, random_ops,
               contrib_ops, detection_ops, rcnn_ops,
               quantization_ops)

__all__ = ["registry"]
