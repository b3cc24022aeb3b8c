"""Execution engine facade.

Counterpart of ``mxnet_tpu/engine.py`` (reference: src/engine/ — the
dependency scheduler with versioned variables, include/mxnet/engine.h).
PyTorch's CUDA streams are the asynchronous engine here: an op returns
as soon as its kernel is queued, and kernels on one stream run in
order. What remains for the framework layer:

- read-after-write ordering on mutable NDArrays: a write through
  ``NDArray._set_data`` installs a fresh tensor and bumps ``version``,
  so an earlier reader of the old tensor keeps its values; the fused
  optimizer apply writes its flat buffers in place and bumps each
  weight's ``version`` likewise (``fused_update.py``);
- blocking waits: ``wait_for_var`` waits for the stream that produced an
  array, ``wait_for_all`` for every card (``torch.cuda.synchronize``);
- a serial debug oracle: ``MXNET_ENGINE_TYPE=NaiveEngine`` (or
  :func:`set_engine_type`) makes the dispatch points that read
  :func:`is_naive` synchronize after each launch, so an asynchronous
  CUDA fault surfaces at the op that caused it;
- ``bulk`` is advisory, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import env as _env

__all__ = [
    "is_naive",
    "set_engine_type",
    "maybe_sync",
    "wait_for_all",
    "wait_for_var",
    "bulk",
    "on_complete",
]


def _naive_default():
    return _env.get("MXNET_ENGINE_TYPE") == "NaiveEngine"


_naive = _naive_default()


def is_naive() -> bool:
    return _naive


def set_engine_type(name: str):
    """Select 'NaiveEngine' (synchronous, debugging oracle) or any of the
    reference's threaded engine names (all map to torch's asynchronous
    dispatch)."""
    global _naive
    _naive = name == "NaiveEngine"


def _sync_tensor(t):
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def maybe_sync(arrays):
    """Called after a launch: in naive mode, wait until the arrays (torch
    tensors or NDArrays) are written."""
    if _naive:
        for a in arrays:
            wait_for_var(a)


def wait_for_var(array):
    """Engine::WaitForVar — block until `array`'s pending writes land."""
    if isinstance(array, torch.Tensor):
        _sync_tensor(array)
    else:
        array.wait_to_read()


def wait_for_all():
    """Engine::WaitForAll (include/mxnet/engine.h:233): wait for every
    card's queued work. An asynchronous CUDA fault raises here, as the
    reference rethrows a stored exception at its wait points."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def bulk(size: int = 0):
    """Engine bulking scope (reference: mx.engine.bulk). Advisory: the
    port dispatches op by op."""
    yield


def on_complete(callback):
    """Run `callback` on a host thread once all currently dispatched work
    completes (reference: Engine::PushAsync host callbacks)."""
    t = threading.Thread(target=lambda: (wait_for_all(), callback()))
    t.daemon = True
    t.start()
    return t
