"""ctypes bindings of NVRTC and the CUDA driver API, for ``rtc.py``.

``libnvrtc`` is searched for in the CUDA toolkit (``$CUDA_HOME/lib64``,
``$CUDA_PATH/lib64``, ``/usr/local/cuda/lib64``) and beside PyTorch's
own CUDA libraries (``torch/lib`` and the ``nvidia/cuda_nvrtc/lib``
wheel directory); ``libcuda`` is the driver's, found by the dynamic
loader. Both are loaded at first use, never at import: the host tests
import every module on machines without CUDA.

Every ``nvrtcResult`` and ``CUresult`` is checked; a failure raises
:class:`CudaError` with the library's own message, and a compile error
carries NVRTC's program log.

Compiled programs are cached per process by (source, options, name
expressions), loaded modules by (program, device): a graph partitioned
into many fragments, once per served bucket, compiles its kernel once.
With the compile cache on (``MXNET_COMPILE_CACHE``, :mod:`.compile`), a
program missing from that dict is first asked of the cache (site
``nvrtc``: this process's store, then a peer's), and a program NVRTC
compiles is committed there: its cubin, lowered names and log, keyed by
the source, options, names, NVRTC's version and the card's capability.

A launch crosses into C once: :func:`launch` hands one packed buffer
(function, context, stream, dims and the kernel's parameters) to
``csrc/rtc_launch.cu``, built by ``_native`` at first use, which makes
the context current where it is not and calls ``cuLaunchKernel``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time

from . import _native
from .base import MXNetError

__all__ = ["CudaError", "search_dirs", "compile_program", "load_function",
           "primary_context", "launch", "nvrtc_version", "driver_version",
           "HEADER", "MAX_PARAMS", "STATS"]

_c_p = ctypes.c_void_p
_lock = threading.RLock()
_libs = {}
_programs = {}   # (source, options, names) -> _Program
_modules = {}    # (program key, device) -> CUmodule handle
_functions = {}  # (program key, device, symbol) -> CUfunction handle
_primary = {}    # device -> primary CUcontext handle

# What the runtime compiler did in this process: "compiles" NVRTC runs
# and their "compile_seconds", "cache_hits" compiles served from this
# process's dict, "store_hits" programs the compile cache served
# instead of NVRTC, "module_loads" cubins loaded onto a device.
STATS = {"compiles": 0, "compile_seconds": 0.0, "cache_hits": 0,
         "store_hits": 0, "module_loads": 0}


class CudaError(MXNetError):
    """An NVRTC or CUDA driver call failed."""


def search_dirs():
    """Directories searched for ``libnvrtc.so*``, in order."""
    dirs = [os.path.join(os.environ[v], "lib64")
            for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    dirs.append("/usr/local/cuda/lib64")
    import torch

    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    dirs.append(os.path.join(torch_dir, "lib"))
    dirs.append(os.path.join(os.path.dirname(torch_dir), "nvidia",
                             "cuda_nvrtc", "lib"))
    return dirs


def _find_nvrtc():
    for d in search_dirs():
        found = sorted(p for p in glob.glob(os.path.join(d, "libnvrtc.so*"))
                       if os.path.isfile(p))
        if found:
            # NVRTC opens its builtins library by soname: load it first
            # from the same directory so the compile finds it.
            for b in sorted(glob.glob(os.path.join(
                    d, "libnvrtc-builtins.so*"))):
                ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                break
            return found[0]
    raise CudaError("libnvrtc.so not found: searched %s (set CUDA_HOME to "
                    "the CUDA toolkit)" % ", ".join(search_dirs()))


def _nvrtc():
    lib = _libs.get("nvrtc")
    if lib is None:
        lib = ctypes.CDLL(_find_nvrtc())
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        for name, args in (
                ("nvrtcVersion", [ctypes.POINTER(ctypes.c_int)] * 2),
                ("nvrtcCreateProgram",
                 [ctypes.POINTER(_c_p), ctypes.c_char_p, ctypes.c_char_p,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                  ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcAddNameExpression", [_c_p, ctypes.c_char_p]),
                ("nvrtcCompileProgram",
                 [_c_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcGetProgramLogSize",
                 [_c_p, ctypes.POINTER(ctypes.c_size_t)]),
                ("nvrtcGetProgramLog", [_c_p, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [_c_p, ctypes.POINTER(ctypes.c_size_t)]),
                ("nvrtcGetCUBIN", [_c_p, ctypes.c_char_p]),
                ("nvrtcGetLoweredName",
                 [_c_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(_c_p)])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _libs["nvrtc"] = lib
    return lib


def _cuda():
    lib = _libs.get("cuda")
    if lib is None:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise CudaError("the CUDA driver library libcuda.so.1 could not "
                            "be loaded: %s" % e) from None
        for name, args in (
                ("cuInit", [ctypes.c_uint]),
                ("cuDriverGetVersion", [ctypes.POINTER(ctypes.c_int)]),
                ("cuGetErrorString",
                 [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]),
                ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int]),
                ("cuDevicePrimaryCtxRetain",
                 [ctypes.POINTER(_c_p), ctypes.c_int]),
                ("cuCtxGetCurrent", [ctypes.POINTER(_c_p)]),
                ("cuCtxSetCurrent", [_c_p]),
                ("cuModuleLoadData", [ctypes.POINTER(_c_p), ctypes.c_char_p]),
                ("cuModuleGetFunction",
                 [ctypes.POINTER(_c_p), _c_p, ctypes.c_char_p]),
                ("cuLaunchKernel",
                 [_c_p] + [ctypes.c_uint] * 7
                 + [_c_p, ctypes.POINTER(_c_p), ctypes.POINTER(_c_p)])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _check_cu(lib, lib.cuInit(0), "cuInit")
        _libs["cuda"] = lib
    return lib


def _check_nvrtc(lib, res, what):
    if res != 0:
        raise CudaError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def _check_cu(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise CudaError("%s failed: CUresult %d (%s)" % (
            what, res, msg.value.decode() if msg.value else "unknown"))


class _Program:
    """A compiled program: its cubin and the lowered names of its name
    expressions."""

    def __init__(self, key, cubin, lowered, log):
        self.key = key
        self.cubin = cubin
        self.lowered = lowered
        self.log = log


def nvrtc_version():
    """NVRTC's version, ``"major.minor"``."""
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return "%d.%d" % (major.value, minor.value)


def driver_version():
    """The CUDA driver's version (``cuDriverGetVersion``: 1000 major +
    10 minor)."""
    lib = _cuda()
    v = ctypes.c_int()
    _check_cu(lib, lib.cuDriverGetVersion(ctypes.byref(v)),
              "cuDriverGetVersion")
    return v.value


def _capability():
    """The compute capability of the current card, part of a program's
    cache key (None on a host without one)."""
    import torch

    return list(torch.cuda.get_device_capability()) \
        if torch.cuda.is_available() else None


def _cache_key(source, options, names):
    from . import compile as _cc

    return _cc.make_key(["nvrtc", source, list(options), list(names),
                         nvrtc_version(), _capability()])


def compile_program(source, options, names):
    """Compile CUDA C++ `source` with NVRTC to a cubin (the options must
    name a real architecture, ``--gpu-architecture=sm_90a``), cached per
    process and, with the compile cache on, across processes. `names`
    are name expressions (templates, C++ functions) whose lowered names
    are kept."""
    key = (source, tuple(options), tuple(names))
    with _lock:
        prog = _programs.get(key)
        if prog is not None:
            STATS["cache_hits"] += 1
            return prog
        lib = _nvrtc()
        from . import compile as _cc

        cache_key = _cache_key(source, options, names) \
            if _cc.enabled() else None
        rec = _cc.fetch("nvrtc", cache_key) if cache_key else None
        if rec is not None:
            fields, cubin = rec
            prog = _Program(key, cubin, fields["lowered"], fields["log"])
            STATS["store_hits"] += 1
        else:
            t0 = time.perf_counter()
            cubin, lowered, log = _compile(lib, source, options, names)
            seconds = time.perf_counter() - t0
            prog = _Program(key, cubin, lowered, log)
            STATS["compiles"] += 1
            STATS["compile_seconds"] += seconds
            if cache_key:
                _cc.commit("nvrtc", cache_key,
                           {"lowered": lowered, "log": log}, cubin, seconds,
                           meta={"options": list(options),
                                 "names": list(names)})
        _programs[key] = prog
        return prog


def _compile(lib, source, options, names):
    """One NVRTC compile: (cubin bytes, {name: lowered name}, log)."""
    handle = _c_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(handle), source.encode(), b"mxnet_rtc.cu", 0,
        None, None), "nvrtcCreateProgram")
    try:
        for n in names:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(
                handle, n.encode()), "nvrtcAddNameExpression(%s)" % n)
        opts = (ctypes.c_char_p * len(options))(
            *[o.encode() for o in options])
        res = lib.nvrtcCompileProgram(handle, len(options), opts)
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetProgramLogSize(
            handle, ctypes.byref(size)), "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetProgramLog(handle, buf),
                     "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        if res != 0:
            raise CudaError("NVRTC compile failed (%s) with options %s:"
                            "\n%s" % (lib.nvrtcGetErrorString(res)
                                      .decode(), list(options), log))
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(
            handle, ctypes.byref(size)), "nvrtcGetCUBINSize")
        if size.value == 0:
            raise CudaError("NVRTC produced no cubin: options %s must "
                            "name a real architecture (sm_XX)"
                            % list(options))
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(handle, cubin),
                     "nvrtcGetCUBIN")
        lowered = {}
        for n in names:
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                handle, n.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%s)" % n)
            lowered[n] = out.value.decode()
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(handle))
    return cubin.raw, lowered, log


def primary_context(device):
    """The primary context (the one PyTorch uses) of `device`, retained
    at first use."""
    with _lock:
        ctx = _primary.get(device)
        if ctx is None:
            lib = _cuda()
            dev = ctypes.c_int()
            _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), device),
                      "cuDeviceGet")
            ctx = _c_p()
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                        dev),
                      "cuDevicePrimaryCtxRetain")
            _primary[device] = ctx
        return ctx


def _make_current(lib, device):
    """Make the device's primary context current on this thread: a
    server's worker thread may never have touched the driver API."""
    ctx = primary_context(device)
    cur = _c_p()
    _check_cu(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_function(prog, symbol, device):
    """The CUfunction `symbol` of `prog` on `device`, loading the module
    there at first use."""
    key = (prog.key, device, symbol)
    with _lock:
        lib = _cuda()
        _make_current(lib, device)
        fn = _functions.get(key)
        if fn is not None:
            return fn
        mod = _modules.get((prog.key, device))
        if mod is None:
            mod = _c_p()
            _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                prog.cubin),
                      "cuModuleLoadData")
            _modules[(prog.key, device)] = mod
            STATS["module_loads"] += 1
        fn = _c_p()
        _check_cu(lib, lib.cuModuleGetFunction(ctypes.byref(fn), mod,
                                               symbol.encode()),
                  "cuModuleGetFunction(%s)" % symbol)
        _functions[key] = fn
        return fn


# The head of a launch buffer (csrc/rtc_launch.cu): function, context,
# stream, grid (3), block (3), shared memory bytes, parameter count; the
# kernel's parameters follow, packed with native alignment.
HEADER = "@PPP8I"
# The most parameters a kernel launched through it may have
# (MX_RTC_MAX_PARAMS there).
MAX_PARAMS = 256


def _launcher():
    """``mx_rtc_launch`` of csrc/rtc_launch.cu, given the driver's entry
    points at first use."""
    fn = _libs.get("launcher")
    if fn is None:
        with _lock:
            fn = _libs.get("launcher")
            if fn is None:
                cuda = _cuda()
                lib = _native.load("rtc_launch")
                lib.mx_rtc_init.argtypes = [_c_p] * 3
                lib.mx_rtc_init.restype = None
                lib.mx_rtc_init(*[ctypes.cast(getattr(cuda, f), _c_p)
                                  for f in ("cuLaunchKernel",
                                            "cuCtxGetCurrent",
                                            "cuCtxSetCurrent")])
                fn = lib.mx_rtc_launch
                fn.argtypes = [ctypes.c_char_p, _c_p]
                fn.restype = ctypes.c_int
                _libs["launcher"] = fn
    return fn


def launch(buffer, params_offset):
    """Launch from `buffer` (bytes: the :data:`HEADER` fields, then the
    kernel's parameters, each at its offset in `params_offset`, the
    address of a uint32 array that stays alive until the call returns)
    on the stream it names, making its context current first where it
    is not."""
    res = _launcher()(buffer, params_offset)
    if res != 0:
        _check_cu(_cuda(), res, "cuLaunchKernel (csrc/rtc_launch.cu)")
