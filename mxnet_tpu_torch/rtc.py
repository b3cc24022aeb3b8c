"""mx.rtc — CUDA kernels compiled at runtime, launched on NDArrays.

Counterpart of ``mxnet_tpu/rtc.py``. The JAX package's runtime kernel
surface is ``PallasModule``/``PallasKernel`` (a Pallas kernel per input
signature through ``pl.pallas_call``, rtc.py:67-106 there); its own
docstring names the reference it stands for, MXNet's ``CudaModule`` over
NVRTC (python/mxnet/rtc.py, src/common/rtc.cc). On an NVIDIA card that
reference is the port::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }
    '''
    module = mx.rtc.CudaModule(source)
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))

``CudaModule`` compiles CUDA C++ with NVRTC for ``sm_90a`` (Hopper) to a
cubin when it is built; a compile error raises with NVRTC's log.
``exports`` names templated or C++ kernels, found through their lowered
names. ``CudaKernel.launch`` checks each array's dtype against its
pointer type, its device against ``ctx`` and its layout (contiguous
only), loads the cubin on the device at first use and launches through
the driver API on PyTorch's current stream of that device. Arrays passed
to a non-``const`` pointer get their ``version`` bumped. Nothing falls
back to the host: a launch on host arrays raises, and so does a missing
NVRTC (see ``_nvrtc.py`` for where it is searched).

A launch packs the function, context, stream, dims and every parameter
into one buffer with a ``struct`` format fixed per kernel (each
parameter at its C alignment) and crosses into C once, through
``csrc/rtc_launch.cu`` (built with ``nvcc`` by ``_native`` at the first
launch): the launcher makes the device's primary context current where
it is not and calls ``cuLaunchKernel``.

``PallasModule`` and ``PallasKernel`` exist for API parity and raise:
Pallas kernels cannot run under PyTorch.
"""
from __future__ import annotations

import ctypes
import os
import re
import struct

import numpy as np
import torch

from . import _nvrtc
from .base import torch_dtype
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel"]

# C type -> dtype name (reference rtc.py:_DTYPE_CPP_TO_NP).
_DTYPE_CPP = {
    "float": "float32", "double": "float64", "__half": "float16",
    "uint8_t": "uint8", "int": "int32", "int32_t": "int32",
    "int8_t": "int8", "char": "int8", "int64_t": "int64",
}
# dtype name -> struct code of a scalar parameter in the launch buffer.
_STRUCT = {
    "float32": "f", "float64": "d",
    "float16": "H",  # the bits of an IEEE half
    "uint8": "B", "int8": "b", "int32": "i", "int64": "q",
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

ARCH = "sm_90a"

# Kernels launched through CudaKernel.launch since import.
LAUNCHES = 0

# Lookups a launch makes, cached: torch.device's attributes cost more
# than a dict lookup.
_devices = {}  # (device type, id) -> torch.device, checked once
_indices = {}  # torch.device of a CUDA card with an index -> the index
_streams = {}  # (device index, raw stream) -> torch.cuda.Stream


def _torch_device(ctx):
    """The torch device of the GPU context `ctx`, checked (a card, an
    existing index) at its first launch."""
    key = (ctx.device_type, ctx.device_id)
    device = _devices.get(key)
    if device is None:
        device = _devices[key] = ctx.torch_device
    return device


def _cuda_index(device):
    """The CUDA device index of `device`, or None where it is no CUDA
    device; ``cuda`` without an index is the current device."""
    index = _indices.get(device)
    if index is None:
        if device is None or device.type != "cuda":
            return None
        if device.index is None:
            return torch.cuda.current_device()
        index = _indices[device] = device.index
    return index


def _current_stream(index):
    """PyTorch's current stream of device `index` as a Stream object,
    one object per raw stream."""
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(index)
    return stream


def parse_signature(signature):
    """[(dtype name, is_pointer, is_const)] of a C parameter list such as
    ``"const float *x, float *y, float alpha"`` (reference
    CudaModule.get_kernel)."""
    params = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(
                'Invalid function prototype "%s". Must be in the form of '
                '"(const) type (*) (name)"' % arg)
        if m.group(2) not in _DTYPE_CPP:
            raise TypeError("Unsupported kernel argument type %s. Supported "
                            "types are: %s." % (arg, ", ".join(_DTYPE_CPP)))
        params.append((_DTYPE_CPP[m.group(2)], bool(m.group(3)),
                       bool(m.group(1))))
    return params


def _default_options():
    opts = ["--gpu-architecture=%s" % ARCH]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        inc = os.path.join(root, "include") if root else None
        if inc and os.path.isdir(inc):
            # so that a kernel may #include <cuda_fp16.h>
            opts.append("--include-path=%s" % inc)
            break
    return opts


class CudaModule:
    """CUDA C++ compiled at runtime (reference rtc.py:CudaModule).

    Parameters
    ----------
    source : str
        CUDA C++ source. Kernels are ``extern "C"``, or named in
        `exports`.
    options : sequence of str
        NVRTC options, after ``--gpu-architecture=sm_90a`` and the CUDA
        include path.
    exports : sequence of str
        Name expressions of templated or C++ kernels, e.g.
        ``"axpy<float>"``; `get_kernel` takes them by that name.
    """

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.options = tuple(_default_options()) + tuple(options)
        self.exports = tuple(exports)
        self._program = _nvrtc.compile_program(source, self.options,
                                               self.exports)

    @property
    def compile_log(self):
        return self._program.log

    def get_kernel(self, name, signature):
        """The kernel `name` (an ``extern "C"`` name or an export) with
        the C parameter list `signature`."""
        symbol = self._program.lowered.get(name, name)
        return CudaKernel(self._program, name, symbol,
                          parse_signature(signature))


class CudaKernel:
    """One kernel of a :class:`CudaModule` (reference rtc.py:CudaKernel)."""

    def __init__(self, program, name, symbol, params):
        if len(params) > _nvrtc.MAX_PARAMS:
            raise ValueError("kernel %s has %d parameters; a launch takes "
                             "at most %d" % (name, len(params),
                                             _nvrtc.MAX_PARAMS))
        self._program = program
        self.name = name
        self._symbol = symbol
        self._params = params
        self._dtypes = [torch_dtype(d) for d, _, _ in params]
        self._pointers = [i for i, (_, is_ptr, _) in enumerate(params)
                          if is_ptr]
        self._halves = [i for i, (d, is_ptr, _) in enumerate(params)
                        if d == "float16" and not is_ptr]
        # The launch buffer: csrc/rtc_launch.cu's header, then each
        # parameter at its C alignment, as the driver reads them.
        codes = ["P" if is_ptr else _STRUCT[d] for d, is_ptr, _ in params]
        self._pack = struct.Struct(_nvrtc.HEADER + "".join(codes)).pack
        offsets = [struct.calcsize(_nvrtc.HEADER + "".join(codes[:i + 1]))
                   - struct.calcsize(codes[i]) for i in range(len(codes))]
        self._offsets = (ctypes.c_uint32 * max(len(codes), 1))(*offsets)
        self._offsets_ptr = ctypes.addressof(self._offsets)
        self._fns = {}  # device index -> (CUfunction, CUcontext) as ints

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on `ctx` (a GPU context) with `grid_dims`/`block_dims`
        (up to three each) and `shared_mem` bytes of dynamic shared
        memory. Pointer parameters take NDArrays on `ctx`, scalar
        parameters take Python numbers."""
        ctx = Context(ctx)
        if ctx.device_type != "gpu":
            raise ValueError("CudaKernel.launch needs a GPU context, got %s"
                             % ctx)
        if len(args) != len(self._params):
            raise ValueError("kernel %s takes %d arguments, got %d"
                             % (self.name, len(self._params), len(args)))
        for i, (arg, (_, is_ptr, _)) in enumerate(zip(args, self._params)):
            if is_ptr and not isinstance(arg, NDArray):
                raise TypeError("argument %d of %s must be an NDArray, got %s"
                                % (i, self.name, type(arg)))
        device = _torch_device(ctx)
        self.launch_tensors(
            [a._data if isinstance(a, NDArray) else a for a in args],
            grid_dims, block_dims, shared_mem, device=device)
        written = [arg for arg, (_, is_ptr, is_const) in zip(args,
                                                             self._params)
                   if is_ptr and not is_const]
        if written:
            stream = _current_stream(device.index)
            for arg in written:
                arg.version += 1
                arg._stream = stream

    def launch_tensors(self, args, grid_dims, block_dims, shared_mem=0,
                       device=None):
        """:meth:`launch` over torch tensors, for the port's own
        wrappers: the pointer parameters take CUDA tensors on one device
        (`device`, default that of the first), checked as in
        :meth:`launch`. Launches on PyTorch's current stream of that
        device."""
        global LAUNCHES
        if len(args) != len(self._params):
            raise ValueError("kernel %s takes %d arguments, got %d"
                             % (self.name, len(self._params), len(args)))
        values = list(args)
        for i in self._pointers:
            arg = args[i]
            if device is None:
                device = arg.device
            if arg.dtype != self._dtypes[i]:
                raise TypeError(
                    "argument %d of %s is expected to be an NDArray of "
                    "type %s, but got %s" % (i, self.name, self._params[i][0],
                                             str(arg.dtype)[6:]))
            if arg.device != device:
                raise ValueError("argument %d of %s lies on %s, not on "
                                 "the launch device %s"
                                 % (i, self.name, arg.device, device))
            if not arg.is_contiguous():
                raise ValueError("argument %d of %s is not contiguous"
                                 % (i, self.name))
            values[i] = arg.data_ptr()
        for i in self._halves:
            values[i] = int(np.float16(args[i]).view(np.uint16))
        index = _cuda_index(device)
        if index is None:
            raise ValueError("kernel %s launches on a CUDA device, got %s"
                             % (self.name, device))
        fn = self._fns.get(index)
        if fn is None:
            fn = self._fns[index] = (
                _nvrtc.load_function(self._program, self._symbol,
                                     index).value,
                _nvrtc.primary_context(index).value)
        grid = (tuple(grid_dims) + (1, 1, 1))[:3]
        block = (tuple(block_dims) + (1, 1, 1))[:3]
        try:
            buffer = self._pack(fn[0], fn[1],
                                torch._C._cuda_getCurrentRawStream(index),
                                *grid, *block, int(shared_mem), len(args),
                                *values)
        except struct.error as e:
            raise TypeError("arguments of %s do not fit its parameters %s "
                            "(grid %s, block %s): %s"
                            % (self.name, [d for d, _, _ in self._params],
                               grid, block, e)) from None
        _nvrtc.launch(buffer, self._offsets_ptr)
        LAUNCHES += 1


class PallasModule:
    """Pallas kernels cannot run under PyTorch: use :class:`CudaModule`
    (mirrors the JAX package's CudaModule stub, rtc.py:134-142 there)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PallasModule compiles Pallas kernels for a TPU; on an NVIDIA "
            "card write the kernel in CUDA C++ and compile it with "
            "mxnet_tpu_torch.rtc.CudaModule (see the module docstring)")


class PallasKernel(PallasModule):
    """See :class:`PallasModule`."""
