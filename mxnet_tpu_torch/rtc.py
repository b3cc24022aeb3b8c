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

``PallasModule`` and ``PallasKernel`` exist for API parity and raise:
Pallas kernels cannot run under PyTorch.
"""
from __future__ import annotations

import ctypes
import os
import re

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
_CTYPE = {
    "float32": ctypes.c_float, "float64": ctypes.c_double,
    "float16": ctypes.c_uint16,  # the bits of an IEEE half
    "uint8": ctypes.c_uint8, "int8": ctypes.c_int8,
    "int32": ctypes.c_int32, "int64": ctypes.c_int64,
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

ARCH = "sm_90a"

# Kernels launched through CudaKernel.launch since import.
LAUNCHES = 0


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
        self._program = program
        self.name = name
        self._symbol = symbol
        self._params = params
        self._dtypes = [torch_dtype(d) for d, _, _ in params]
        self._fns = {}  # device index -> CUfunction

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
        stream = self.launch_tensors(
            [a._data if isinstance(a, NDArray) else a for a in args],
            grid_dims, block_dims, shared_mem, device=ctx.torch_device)
        for arg, (_, is_ptr, is_const) in zip(args, self._params):
            if is_ptr and not is_const:
                arg.version += 1
                arg._stream = stream

    def launch_tensors(self, args, grid_dims, block_dims, shared_mem=0,
                       device=None):
        """:meth:`launch` over torch tensors, for the port's own
        wrappers: the pointer parameters take CUDA tensors on one device
        (`device`, default that of the first), checked as in
        :meth:`launch`. Returns the stream launched on."""
        global LAUNCHES
        if len(args) != len(self._params):
            raise ValueError("kernel %s takes %d arguments, got %d"
                             % (self.name, len(self._params), len(args)))
        values = []
        for i, (arg, (dtype, is_ptr, _), tdt) in enumerate(
                zip(args, self._params, self._dtypes)):
            if is_ptr:
                if device is None:
                    device = arg.device
                if arg.dtype != tdt:
                    raise TypeError(
                        "argument %d of %s is expected to be an NDArray of "
                        "type %s, but got %s" % (i, self.name, dtype,
                                                 str(arg.dtype)[6:]))
                if arg.device != device:
                    raise ValueError("argument %d of %s lies on %s, not on "
                                     "the launch device %s"
                                     % (i, self.name, arg.device, device))
                if not arg.is_contiguous():
                    raise ValueError("argument %d of %s is not contiguous"
                                     % (i, self.name))
                values.append(ctypes.c_void_p(arg.data_ptr()))
            elif dtype == "float16":
                values.append(ctypes.c_uint16(
                    int(np.float16(arg).view(np.uint16))))
            else:
                values.append(_CTYPE[dtype](arg))
        if device is None or device.type != "cuda":
            raise ValueError("kernel %s launches on a CUDA device, got %s"
                             % (self.name, device))
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        fn = self._fns.get(index)
        if fn is None:
            fn = self._fns[index] = _nvrtc.load_function(
                self._program, self._symbol, index)
        grid = (tuple(grid_dims) + (1, 1, 1))[:3]
        block = (tuple(block_dims) + (1, 1, 1))[:3]
        stream = torch.cuda.current_stream(device)
        _nvrtc.launch(fn, index, grid, block, int(shared_mem),
                      stream.cuda_stream, values)
        LAUNCHES += 1
        return stream


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
