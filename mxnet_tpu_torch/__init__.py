"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` stays the reference; this package keeps
its module names and public API (``import mxnet_tpu_torch as mx``) over
torch tensors, and replaces each of its TPU (Pallas) kernels with a
kernel written by hand for NVIDIA Hopper. It imports nothing of JAX and
nothing of ``mxnet_tpu``.

Entry points run on ``gpu(0)`` unless the caller asks for the host::

    import mxnet_tpu_torch as mx
    a = mx.nd.ones((2, 3))                  # on cuda:0
    with mx.cpu():
        b = mx.nd.ones((2, 3))              # on the host
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, gpu, tpu, current_context, num_gpus
from . import random
from . import ndarray
from . import ndarray as nd
from . import autograd
from . import name
from . import engine
from . import util
from .ndarray import NDArray
from .attribute import AttrScope

_LAZY = {
    "gluon": ".gluon",
    "initializer": ".initializer",
    "init": ".initializer",
    "serving": ".serving",
    "cached_op": ".cached_op",
    "parallel": ".parallel",
    "symbol": ".symbol",
    "sym": ".symbol",
    "executor": ".executor",
    "model": ".model",
    "subgraph": ".subgraph",
    "rtc": ".rtc",
    "attribute": ".attribute",
    "optimizer": ".optimizer",
    "lr_scheduler": ".lr_scheduler",
    "metric": ".metric",
    "callback": ".callback",
    "kvstore": ".kvstore",
    "kv": ".kvstore",
    "kvstore_dist": ".kvstore_dist",
    "kvstore_server": ".kvstore_server",
    "gradient_compression": ".gradient_compression",
    "fused_update": ".fused_update",
    "telemetry": ".telemetry",
    "env": ".env",
    "registry_util": ".registry_util",
    "recordio": ".recordio",
    "recordio_native": ".recordio_native",
    "io": ".io",
    "image": ".image",
    "img": ".image",
    "data": ".data",
    "log": ".log",
    "profiler": ".profiler",
    "libinfo": ".libinfo",
    "checkpoint": ".checkpoint",
    "compile": ".compile",
    "module": ".module",
    "mod": ".module",
    "rnn": ".rnn",
    "operator": ".operator_custom",
    "contrib": ".contrib",
    "test_utils": ".test_utils",
    "visualization": ".visualization",
    "viz": ".visualization",
    "monitor": ".monitor",
}


def __getattr__(attr):
    target = _LAZY.get(attr)
    if target is None:
        raise AttributeError("module 'mxnet_tpu_torch' has no attribute %r"
                             % attr)
    import importlib

    mod = importlib.import_module(target, __name__)
    globals()[attr] = mod
    return mod


def waitall():
    ndarray.waitall()


# A process launched with DMLC_ROLE=server/scheduler runs the blocking
# parameter-server loop here and never returns to the user script, as in
# the reference's python/mxnet/kvstore_server.py bootstrap. Nothing
# imported above touches CUDA.
import os as _os

if _os.environ.get("DMLC_ROLE", "").lower() in ("server", "scheduler"):
    from .kvstore_server import _init_kvstore_server_module

    _init_kvstore_server_module()
