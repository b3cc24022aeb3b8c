"""Device context.

Counterpart of ``mxnet_tpu/context.py``. A Context names a torch device:
``cpu(i)`` the host, ``gpu(i)`` CUDA device ``i``. ``tpu(i)`` is kept
as an alias of ``gpu(i)`` so scripts written for the JAX package run
unchanged.

The default context is ``gpu(0)``, always. Unlike the JAX package, the
port never picks the host on its own when no accelerator is present:
the first use of a GPU context without a CUDA device raises
``RuntimeError``. Only a caller that asks for the host
(``with mx.cpu():`` or ``ctx=mx.cpu()``) computes there.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus"]

_context_stack = threading.local()


class Context:
    """A device on which NDArrays live and ops execute.

    ``device_type`` is ``'cpu'`` or ``'gpu'``; ``'tpu'`` is accepted as
    an alias of ``'gpu'``.
    """

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
            return
        if device_type == "tpu":
            device_type = "gpu"
        if device_type in ("cpu_pinned", "cpu_shared"):
            device_type = "cpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device type %s" % device_type)
        self.device_type = device_type
        self.device_id = device_id

    @property
    def torch_device(self):
        """The torch device; raises RuntimeError for a GPU context when
        no CUDA device exists."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "context %s needs a CUDA device and none is available; "
                "pass ctx=mx.cpu() (or use `with mx.cpu():`) to compute "
                "on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("no CUDA device %d (found %d)"
                               % (self.device_id, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(_context_stack, "stack"):
            _context_stack.stack = []
        _context_stack.stack.append(self)
        return self

    def __exit__(self, *args):
        _context_stack.stack.pop()

    def empty_cache(self):
        """Return this card's cached, unused memory to CUDA
        (``torch.cuda.empty_cache`` on its device; reference
        Context::empty_cache). The host has no such cache."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()

    @classmethod
    def default_ctx(cls):
        stack = getattr(_context_stack, "stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)

    @classmethod
    def of(cls, device):
        """The Context of a torch device."""
        if device.type == "cpu":
            return cls("cpu", 0)
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        raise ValueError("unsupported torch device %s" % device)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, so scripts written for the JAX package run."""
    return Context("gpu", device_id)


def current_context():
    return Context.default_ctx()


def num_gpus():
    return torch.cuda.device_count()
