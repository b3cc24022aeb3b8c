"""Where the host time of an rtc launch goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card::

    python3 -m mxnet_tpu_torch.profile_rtc [--calls 1000] [--sweep]

An rtc kernel is launched from Python through ``rtc.CudaKernel`` and the
driver's ``cuLaunchKernel``. At small sizes the host's launch cost, not
the kernel, sets the time of a call. This script splits that cost. It
prints the card's name and power limit, then JSON lines:

- ``per_call_us``: host microseconds per call (the median of 5 windows
  of ``calls / 5`` back-to-back calls, the card synchronised between
  windows) of the wrapper ``rtc_kernels.relu`` at 32x4096, of
  ``CudaKernel.launch`` on NDArrays and of ``launch_tensors`` on
  tensors (the relu kernel, 3 parameters), of ``CudaKernel.launch`` of
  the fused BatchNorm+ReLU kernel (11 parameters, as chip_smoke's
  ``host_us_per_launch``) and of ``fused_bn_relu.bn_relu`` on a 1-element
  input (chip_smoke's ``host_us_per_bn_relu_call``); beside them the
  pieces such a launch is made of, each timed alone: ``torch.empty_like``,
  ``torch.cuda.current_stream(dev).cuda_stream``, ``cuCtxGetCurrent`` and
  ``cuLaunchKernel`` called through ctypes with their arguments built
  beforehand, the launcher of ``csrc/rtc_launch.cu`` with its buffer
  packed beforehand (where the tree has it), and ``F.relu`` (the library
  call's own host cost);
- ``cprofile``: for ``calls`` wrapper calls and ``calls`` bare launches,
  the functions with the most own time (``tottime``), in microseconds
  per call. A ctypes foreign call is no function to cProfile: its time,
  conversion of the arguments and the driver's own work, counts as the
  own time of the Python function that makes it;
- ``sweep`` (with ``--sweep``): the device time in microseconds of the
  elementwise kernels (``csrc/rtc/elementwise.cu``) at relu 32x4096,
  relu 4096x4096 and scale_add 4096x4096, for grids of several sizes
  (blocks of 256 threads) and float4 vectors per thread per whole trip
  (``ELEMENTWISE_VECTORS`` 1, 2, 4, 8), and on views whose pointers are
  not 16-byte aligned; with the grid ``launch_plan`` picks.
  Device time: CUDA events around 50 launches queued behind a sleep
  kernel, the median of 5 such windows.
"""
from __future__ import annotations

import argparse
import cProfile
import ctypes
import json
import pstats
import struct
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F


def _per_call_us(fn, calls):
    """Median host microseconds of one `fn` over 5 windows."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    reps = max(calls // 5, 1)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def _cprofile(fn, calls, top=12):
    """The `top` functions by own time over `calls` calls of `fn`:
    [name, calls per call, tottime us per call, cumtime us per call]."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = []
    for (path, line, name), (_, ncalls, tt, ct, _) in stats.items():
        short = "/".join(path.split("/")[-2:])
        rows.append(["%s:%d(%s)" % (short, line, name), ncalls / calls,
                     tt / calls * 1e6, ct / calls * 1e6])
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    return {"total_us": total, "top": rows[:top]}


def _device_us(fn, reps=50, iters=5):
    """Median device microseconds of one `fn`, the card kept ahead of the
    host: `reps` calls queued behind a sleep kernel, timed by events."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 5_000_000, []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) * 1e3 / reps)
        elif cycles > 1e11:
            raise RuntimeError("profile_rtc: the host never got ahead")
        else:
            cycles *= 2
    return float(np.median(times))


def _sweep(dev):
    """Device time of the elementwise kernels over grids and vector
    counts; one JSON line per case."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.examples import rtc_kernels

    with open(rtc_kernels.SOURCE) as f:
        source = f.read()
    variants = {"vectors %d" % v: ("-DELEMENTWISE_VECTORS=%d" % v,)
                for v in (1, 2, 4, 8)}
    sigs = {"relu": "const float *x, float *y, int64_t n",
            "scale_add": "const float *x, const float *y, float *out, "
                         "int64_t n"}
    kernels = {v: {k: rtc.CudaModule(source, opts).get_kernel(k, sig)
                   for k, sig in sigs.items()}
               for v, opts in variants.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, shape in (("relu", (32, 4096)), ("relu", (4096, 4096)),
                        ("scale_add", (4096, 4096))):
        ins = [torch.randn(shape, generator=gen, device=dev)
               for _ in range(2 if name == "scale_add" else 1)]
        out = torch.empty(shape, device=dev)
        n = out.numel()
        full = -(-n // 4 // 256)  # one float4 a thread
        grids = sorted({g for g in [full >> k for k in range(8)]
                        + [sms * m for m in (1, 2, 4, 8, 16)]
                        if 1 <= g <= full})
        times = {}
        for v, ks in kernels.items():
            k = ks[name]
            times[v] = {g: _device_us(
                lambda: k.launch_tensors(ins + [out, n], (g,), (256,)))
                for g in grids}
        plan = rtc_kernels.launch_plan(n, 0)[3]
        k = kernels["vectors %d" % rtc_kernels.VECTORS][name]
        planned = _device_us(
            lambda: k.launch_tensors(ins + [out, n], (plan,), (256,)))
        # Views one element past an aligned start: every pointer at offset
        # 1 (a head of 3 scalars), and the inputs only (pointers differ
        # mod 16: the scalar path).
        base = [torch.randn(n + 1, generator=gen, device=dev)
                for _ in range(len(ins) + 1)]
        views = [b[1:] for b in base]
        aligned_out = torch.empty(n, device=dev)
        offset = {
            "all at offset 1": _device_us(lambda: k.launch_tensors(
                views + [n], (plan,), (256,))),
            "inputs at offset 1, output aligned": _device_us(
                lambda: k.launch_tensors(
                    views[:-1] + [aligned_out, n],
                    (rtc_kernels.launch_plan(n, None)[3],), (256,)))}
        print(json.dumps({"sweep": name, "shape": list(shape),
                          "device_us_by_variant_and_blocks": times,
                          "launch_plan_blocks": plan,
                          "launch_plan_us": planned,
                          "unaligned_us": offset}), flush=True)
        del ins, out, base, views, aligned_out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--sweep", action="store_true",
                        help="also time the elementwise kernels' design "
                             "choices on the device")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rtc: needs a CUDA device", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc
    from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    calls = args.calls
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pre = torch.randn(32, 4096, generator=gen, device=dev)
    out = torch.empty_like(pre)
    n = pre.numel()
    relu_k = rtc_kernels.module().get_kernel(
        "relu", "const float *x, float *y, int64_t n")
    xa, ya = NDArray(pre), NDArray(out)
    ctx = mx.gpu(0)
    bn_k = fused_bn_relu._get_kernel()
    tiny = [NDArray(torch.zeros(1, device=dev)) for _ in range(6)]
    one = torch.ones(1, device=dev)
    x1 = torch.zeros(1, 1, 1, 1, device=dev)
    grid, block = (n // 256,), (256,)

    # The driver call alone, its arguments built beforehand.
    lib = _nvrtc._cuda()
    fn = _nvrtc.load_function(relu_k._program, relu_k._symbol, 0)
    params = [ctypes.c_void_p(pre.data_ptr()),
              ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(n)]
    ptrs = (ctypes.c_void_p * 3)(*[ctypes.addressof(p) for p in params])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cur = ctypes.c_void_p()

    def cu_launch():
        lib.cuLaunchKernel(fn, grid[0], 1, 1, block[0], 1, 1, 0, stream,
                           ptrs, None)

    cases = {
        "rtc_kernels.relu 32x4096": lambda: rtc_kernels.relu(pre),
        "CudaKernel.launch relu (NDArrays)":
            lambda: relu_k.launch([xa, ya, n], ctx, grid, block),
        "CudaKernel.launch_tensors relu":
            lambda: relu_k.launch_tensors([pre, out, n], grid, block),
        "CudaKernel.launch bn_relu_forward (11 params)":
            lambda: bn_k.launch(tiny + [1, 1, 1, 1e-5, 0], ctx, (1,),
                                (32,)),
        "fused_bn_relu.bn_relu 1 element":
            lambda: fused_bn_relu.bn_relu(x1, one, one, one, one, 1e-5,
                                          False, 1),
        "torch.empty_like": lambda: torch.empty_like(pre),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "cuCtxGetCurrent via ctypes":
            lambda: lib.cuCtxGetCurrent(ctypes.byref(cur)),
        "cuLaunchKernel via ctypes, arguments prebuilt": cu_launch,
        "F.relu": lambda: F.relu(pre),
    }
    if hasattr(_nvrtc, "HEADER"):  # the launcher of csrc/rtc_launch.cu
        relu_k.launch_tensors([pre, out, n], grid, block)
        offsets = (ctypes.c_uint32 * 3)(56, 64, 72)
        buffer = struct.pack(
            _nvrtc.HEADER + "PPq", fn.value,
            _nvrtc.primary_context(0).value,
            torch.cuda.current_stream(dev).cuda_stream, grid[0], 1, 1,
            block[0], 1, 1, 0, 3, pre.data_ptr(), out.data_ptr(), n)
        cases["C launcher via ctypes, buffer prebuilt"] = \
            lambda: _nvrtc.launch(buffer, ctypes.addressof(offsets))
    per_call = {k: _per_call_us(f, calls) for k, f in cases.items()}
    print(json.dumps({"per_call_us": per_call, "calls": calls}),
          flush=True)
    for name in ("rtc_kernels.relu 32x4096",
                 "CudaKernel.launch relu (NDArrays)"):
        print(json.dumps({"cprofile": name, "calls": calls,
                          **_cprofile(cases[name], calls)}), flush=True)
    if args.sweep:
        _sweep(dev)
    want = torch.relu(pre)
    got = rtc_kernels.relu(pre)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        print("profile_rtc: the relu kernel disagrees with torch.relu",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
