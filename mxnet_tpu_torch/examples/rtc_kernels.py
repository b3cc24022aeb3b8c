"""Elementwise kernels compiled at runtime through ``rtc.CudaModule``.

The counterparts of the JAX package's rtc fixtures, as wrappers over
torch tensors: ``scale_add`` (``o = 2 x + y``, tests/test_contrib.py:
201-211 there) and ``relu`` over the output of a matmul (the fused relu
of tests/test_subgraph_nce.py:109-142), both fp32, from
``csrc/rtc/elementwise.cu``. Each wrapper launches its kernel on a CUDA tensor and
counts the launch in ``LAUNCHES``; a host tensor gets the plain PyTorch
version beside it. A CUDA tensor never falls back: a failed compile or
launch raises.

The kernels move 16-byte float4 vectors, with a scalar head up to the
first 16-byte boundary and a scalar tail; where the pointers differ mod
16 every element takes the scalar path. Their loops are grid-stride, so
any grid a caller passes through ``CudaKernel.launch`` is right;
:func:`launch_plan` gives the split and the grid the wrappers launch
(one float4 a thread), :func:`launch_elementwise` launches with it.
"""
from __future__ import annotations

import os
import threading

import torch

from .. import rtc

__all__ = ["SOURCE", "LAUNCHES", "module", "launch_1d", "launch_plan",
           "launch_elementwise", "scale_add", "scale_add_reference", "relu",
           "relu_reference"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "rtc", "elementwise.cu")

# Kernel launches by the wrappers below since import.
LAUNCHES = {"scale_add": 0, "relu": 0}

_THREADS = 256
# float4 vectors of each input a thread loads per whole trip in
# csrc/rtc/elementwise.cu (ELEMENTWISE_VECTORS there), for grids smaller
# than the work; and scalars a thread takes per trip on the scalar path.
VECTORS = 4
SCALARS = 4
_lock = threading.Lock()
_module = []
_sms = {}  # device -> multiprocessor count


def module():
    """The compiled CudaModule of elementwise.cu (compiled once)."""
    if not _module:
        with _lock:
            if not _module:
                with open(SOURCE) as f:
                    _module.append(rtc.CudaModule(f.read()))
    return _module[0]


def launch_1d(kernel, tensors, scalars, n):
    """Launch a grid-stride kernel over `n` elements of `tensors` (CUDA,
    one device) followed by the scalar parameters: 256 threads a block,
    at most 8 blocks per multiprocessor."""
    device = tensors[0].device
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    blocks = max(1, min((n + _THREADS - 1) // _THREADS, 8 * sms))
    kernel.launch_tensors(list(tensors) + list(scalars), (blocks,),
                          (_THREADS,))


def launch_plan(n, offset):
    """How the kernels of elementwise.cu split `n` elements, and the grid
    that covers them.

    `offset` is the element offset (0-3) of every pointer past a 16-byte
    boundary, or None where the pointers differ mod 16. Returns (head,
    vectors, tail, blocks): `head` scalar elements up to the first
    boundary, `vectors` float4 after them, `tail` scalars after those
    (head + 4 vectors + tail == n; all scalars where offset is None), and
    the blocks of 256 threads to launch: one float4 a thread (as ATen's
    vectorized kernels), SCALARS a thread on the scalar path. A grid of
    whole trips of VECTORS float4 a thread measured no faster at
    4096x4096 and slower at 32x4096, where it leaves multiprocessors
    idle (``python3 -m mxnet_tpu_torch.profile_rtc --sweep``)."""
    head = n if offset is None else min(n, (4 - offset) % 4)
    vectors = (n - head) // 4
    tail = n - head - 4 * vectors
    threads = max(vectors, -(-(head + tail) // SCALARS), 1)
    return head, vectors, tail, -(-threads // _THREADS)


def launch_elementwise(kernel, tensors, n):
    """Launch a kernel of elementwise.cu over `n` elements of `tensors`
    (CUDA, one device, contiguous; the output last), with the grid of
    :func:`launch_plan`."""
    mis = {t.data_ptr() & 15 for t in tensors}
    offset = mis.pop() >> 2 if len(mis) == 1 else None
    blocks = launch_plan(n, offset)[3]
    kernel.launch_tensors(list(tensors) + [n], (blocks,), (_THREADS,))


_kernels = {}


def _kernel(name, signature):
    k = _kernels.get(name)
    if k is None:
        k = _kernels[name] = module().get_kernel(name, signature)
    return k


def _check(*tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("the rtc elementwise kernels take float32, got "
                            "%s" % t.dtype)


def scale_add_reference(x, y):
    return 2.0 * x + y


def scale_add(x, y):
    """``2 x + y``: the rtc kernel on CUDA tensors, the plain version on
    host tensors. The kernel does not broadcast: x and y have one
    shape."""
    if x.shape != y.shape:
        raise ValueError("scale_add: x %s and y %s differ in shape"
                         % (tuple(x.shape), tuple(y.shape)))
    if x.is_cpu:
        return scale_add_reference(x, y)
    _check(x, y)
    out = torch.empty_like(x)
    launch_elementwise(_kernel("scale_add", "const float *x, const float *y, "
                               "float *out, int64_t n"), (x, y, out),
                       x.numel())
    LAUNCHES["scale_add"] += 1
    return out


def relu_reference(x):
    return torch.relu(x)


def relu(x):
    """``max(x, 0)``: the rtc kernel on CUDA tensors, the plain version on
    host tensors. NaN passes through; on the card -0.0 gives +0.0, as
    F.relu does there."""
    if x.is_cpu:
        return relu_reference(x)
    _check(x)
    y = torch.empty_like(x)
    launch_elementwise(_kernel("relu", "const float *x, float *y, int64_t n"),
                       (x, y), x.numel())
    LAUNCHES["relu"] += 1
    return y
