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
           "is_np_shape", "set_np_shape", "pin_platform",
           "platform_context"]


def _platform(choice):
    """The Context a device choice names: None for ``"auto"``/None/""
    (the current context stays), ``cpu(0)`` or ``gpu(0)``. Anything
    else raises — including values arriving through an environment
    variable, which bypass argparse ``choices=``."""
    if choice in (None, "", "auto"):
        return None
    if choice not in ("cpu", "gpu"):
        raise ValueError("pin_platform: unknown device %r "
                         "(expected auto/cpu/gpu)" % (choice,))
    from .context import cpu, gpu

    return cpu() if choice == "cpu" else gpu()


def pin_platform(choice):
    """Honor a device choice in-process: ``"cpu"`` makes the host the
    default context of this thread from here on (``Context.__enter__``
    without an exit), ``"gpu"`` keeps the port's default, ``gpu(0)``
    (a missing card raises at first use), and ``"auto"``/None does
    nothing. Anything else raises."""
    ctx = _platform(choice)
    if ctx is not None and ctx.device_type == "cpu":
        ctx.__enter__()


def platform_context(choice):
    """The scoped form of :func:`pin_platform`, for tools whose
    ``main(argv)`` runs inside another program: ``with
    platform_context(choice):`` makes ``cpu(0)`` or ``gpu(0)`` the
    current context for the block, and ``"auto"``/None keeps the
    caller's. The same values, the same error."""
    import contextlib

    ctx = _platform(choice)
    return contextlib.nullcontext() if ctx is None else ctx


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
