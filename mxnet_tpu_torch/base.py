"""Foundation types of the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: the framework error type and the
dtype vocabulary. MXNet names dtypes with numpy names; numpy has no
bfloat16, so every dtype argument of the port goes through
:func:`torch_dtype`, which accepts numpy dtypes, their names, the name
``"bfloat16"`` and torch dtypes alike.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

__all__ = ["MXNetError", "mx_real_t", "torch_dtype", "dtype_name",
           "numpy_dtype", "numeric_types", "string_types", "atomic_write"]

# The process umask, read once (os.umask can only be read by setting it).
_UMASK = os.umask(0)
os.umask(_UMASK)


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py:MXNetError)."""


@contextlib.contextmanager
def atomic_write(fname, mode="wb"):
    """Crash-safe file write, as ``mxnet_tpu/base.py:atomic_write``:
    yields a handle to a temp file in the same directory; on a clean
    exit the content is fsynced and renamed over `fname` in one step, on
    an error the temp file is removed. A crash leaves the old file or a
    stray ``.tmp*``, never a truncated `fname`."""
    d, base = os.path.split(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(prefix=base + ".tmp", dir=d)
    os.fchmod(fd, 0o666 & ~_UMASK)
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


string_types = (str,)
numeric_types = (float, int, np.generic)

# Default real type (reference: mx_real_t = np.float32).
mx_real_t = np.float32

_BY_NAME = {
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


def torch_dtype(dtype):
    """Map a dtype in any of the accepted spellings to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError("unsupported dtype %r" % (dtype,)) from None


def dtype_name(dtype):
    """Canonical name (``"float32"``, ``"bfloat16"``, ...) of a dtype."""
    return _NAME_OF[torch_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype an array of `dtype` converts to on the host:
    bfloat16, which numpy lacks, widens to float32."""
    name = dtype_name(dtype)
    return np.dtype(np.float32 if name == "bfloat16" else name)
