"""Runtime/library information (reference: python/mxnet/libinfo.py +
src/libinfo.cc feature flags).

Counterpart of ``mxnet_tpu/libinfo.py``. The port has no libmxnet.so
either: its native code is the libraries it builds from ``csrc/`` into
``_build/`` (nvcc for the CUDA kernels and the rtc launcher, g++ for
the RecordIO reader), and :func:`find_lib_path` lists those that are
built. :func:`features` keeps the JAX package's keys, each set for the
port: CUDA, cuDNN and NCCL as the installed torch has them, the TPU/XLA
flags false.
"""
from __future__ import annotations

import os

__all__ = ["find_lib_path", "features", "__version__"]

__version__ = "2.0.0.torch"

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def find_lib_path():
    """Paths of the port's built native libraries, ``_build/*.so``
    (reference libinfo.py:26 returns libmxnet.so candidates); empty
    before the first build."""
    if not os.path.isdir(_BUILD):
        return []
    return sorted(os.path.join(_BUILD, n) for n in os.listdir(_BUILD)
                  if n.endswith(".so"))


def features():
    """Capability flags (reference runtime.Features / libinfo.cc):
    name -> enabled, for the PyTorch/CUDA runtime. Reading them never
    initialises CUDA."""
    import torch

    cuda = torch.version.cuda is not None
    return {
        "TPU": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "XLA": False,
        "SPMD": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": _has("cv2"),
        "DIST_KVSTORE": True,
        "INT8": True,             # ops/quantization_ops.py
        "BF16": True,
        "SIGNAL_HANDLER": False,
        "PROFILER": True,
    }


def _has(mod):
    import importlib.util

    return importlib.util.find_spec(mod) is not None
