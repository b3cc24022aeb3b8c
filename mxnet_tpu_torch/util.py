"""Misc utilities (reference: python/mxnet/util.py).

Counterpart of ``mxnet_tpu/util.py``: the device queries read
``torch.cuda``, ``pin_platform`` takes ``auto|cpu|gpu``, and the
np-shape helpers are the JAX package's, unchanged.
"""
from __future__ import annotations

import functools
import os

import torch

__all__ = ["makedirs", "get_gpu_count", "get_gpu_memory", "use_np_shape",
           "is_np_shape", "set_np_shape", "pin_platform"]


def pin_platform(choice):
    """Honor a device choice in-process: ``"cpu"`` makes the host the
    default context of this thread from here on (``Context.__enter__``
    without an exit), ``"gpu"`` keeps the port's default, ``gpu(0)``
    (a missing card raises at first use), and ``"auto"``/None does
    nothing. Anything else raises — including values arriving through
    an environment variable, which bypass argparse ``choices=``."""
    if choice in (None, "auto"):
        return
    if choice not in ("cpu", "gpu"):
        raise ValueError("pin_platform: unknown device %r "
                         "(expected auto/cpu/gpu)" % (choice,))
    if choice == "cpu":
        from .context import cpu

        cpu().__enter__()


_np_shape = [True]  # torch shapes are numpy-semantic natively


def makedirs(d):
    """mkdir -p (reference util.py:makedirs)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    return torch.cuda.device_count()


def get_gpu_memory(gpu_dev_id=0):
    """(free, total) bytes of a card, from ``torch.cuda.mem_get_info``;
    (-1, -1) when there is no such card."""
    if not torch.cuda.is_available() or \
            gpu_dev_id >= torch.cuda.device_count():
        return (-1, -1)
    free, total = torch.cuda.mem_get_info(gpu_dev_id)
    return (int(free), int(total))


def set_np_shape(active):
    """Zero-dim/zero-size shape semantics toggle (reference
    util.py:set_np_shape). Torch shapes are numpy-semantic natively, so
    this records-and-returns; nothing needs switching."""
    prev = _np_shape[0]
    _np_shape[0] = bool(active)
    return prev


def is_np_shape():
    return _np_shape[0]


def use_np_shape(func):
    """Decorator form (reference util.py:use_np_shape)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        prev = set_np_shape(True)
        try:
            return func(*args, **kwargs)
        finally:
            set_np_shape(prev)

    return wrapper
