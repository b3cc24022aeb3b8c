#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (no
phase falls back to the host or to a plain version):

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA source of the port (timed).
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs, and timed at the serving shape beside its plain version,
   the library call that computes the same function, and its bound.
4. attention served: ``InferenceServer`` over
   ``nd.contrib.flash_attention`` (16 heads x 64, T 2048, causal, bf16).
5. ResNet-50 v1 served at full width (224x224, 1000 classes, buckets
   1/8/32) in fp32 and bf16; fp32 outputs against the same net on the
   host, and img/s at batch 32.

Then one ``{"kernels": [...]}`` line and, last, one
``{"ok": true, "device": {...}}`` line. The weights are random, from a
seed. Timings are CUDA-event medians of 20 runs after warmup.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
ITERS = 20

# Published dense peaks (NVIDIA data sheets, SXM parts): FLOP/s by
# input dtype and memory bytes/s.
PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
             "bytes": 3.35e12},
    "H200": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
             "bytes": 4.8e12},
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=ITERS, warmup=3):
    """Median CUDA-event time of `fn` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def attention_bound(card, b, h, tq, tk, d, causal, dtype):
    """Least time (ms) for the work of one attention forward on `card`:
    the larger of FLOPs over the dtype's peak and bytes (Q, K, V, O
    each read or written once, fp32 LSE) over the memory rate."""
    peaks = PEAKS["H200" if "H200" in card else "H100"]
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 4.0 * b * h * tq * tk * d * (0.5 if causal and tq == tk else 1.0)
    nbytes = (2 * tq + 2 * tk) * b * h * d * elt + 4 * b * h * tq
    t_ops = flops / peaks[str(dtype).split(".")[1]]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def max_violation(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


# -- phases -------------------------------------------------------------------

def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs "
          "on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("card:", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    # The plain versions and the fp32 comparisons are strict fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    _native.build()
    seconds = time.perf_counter() - t0
    for name in _native.SOURCES:
        regs = [ln.strip() for ln in _native.build_log(name).splitlines()
                if "registers" in ln]
        log("built %s: %d kernel instantiations" % (name, len(regs)))
        for ln in regs:
            log("  ", ln)
    log("build_seconds", round(seconds, 3))


def phase_kernels(card):
    """Flash-attention forward kernel against its plain version."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(shape_q, shape_k, dtype):
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in (shape_q, shape_k, shape_k))

    # fp32: the JAX package's test tolerance. bf16/fp16: the kernel and
    # the plain version compute in fp32 from the same rounded inputs and
    # each rounds O once to the input dtype, so O may differ by one
    # rounding step (2^-8 relative in bf16, 2^-11 in fp16) plus the fp32
    # summation-order difference; LSE stays fp32 in both.
    cases = [
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, True, 2e-4, 2e-5),
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, False, 2e-4, 2e-5),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, False, 2e-4, 2e-5),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, True, 2e-4, 2e-5),
    ]
    for d in (64, 128):
        for dt in (torch.bfloat16, torch.float16):
            cases.append(((2, 16, 2048, d), (2, 16, 2048, d), dt, True,
                          1e-2, 1e-2))
    launches0 = fa.LAUNCHES
    calls = 0
    for shape_q, shape_k, dt, causal, rtol, atol in cases:
        q, k, v = inputs(shape_q, shape_k, dt)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        calls += 1
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        causal=causal)
        lse_tol = (rtol, atol) if dt == torch.float32 else (1e-4, 1e-4)
        v_out = max_violation(out, ref_out, rtol, atol)
        v_lse = max_violation(lse, ref_lse, *lse_tol)
        log(json.dumps({
            "check": "flash_attention_fwd vs plain", "q": shape_q,
            "k": shape_k, "dtype": str(dt).split(".")[1], "causal": causal,
            "max_abs_err_out": float((out.float() - ref_out.float())
                                     .abs().max()),
            "max_abs_err_lse": float((lse - ref_lse).abs().max()),
            "rtol": rtol, "atol": atol, "lse_tol": lse_tol,
            "within": v_out <= 0 and v_lse <= 0}))
        check(v_out <= 0 and v_lse <= 0,
              "flash_attention_fwd disagrees with its plain version at "
              "%s/%s %s causal=%s" % (shape_q, shape_k, dt, causal))
    check(fa.LAUNCHES - launches0 == calls,
          "LAUNCHES rose by %d for %d calls" % (fa.LAUNCHES - launches0,
                                                calls))

    # The serving shape: bucket 8 of the served attention function.
    b, h, t, d, dt = 8, 16, 2048, 64, torch.bfloat16
    q, k, v = inputs((b, h, t, d), (b, h, t, d), dt)
    out, _ = fa.flash_attention_forward(q, k, v, causal=True)
    ref_out, _ = fa.flash_attention_reference(q, k, v, causal=True)
    err = float((out.float() - ref_out.float()).abs().max())
    check(max_violation(out, ref_out, 1e-2, 1e-2) <= 0,
          "flash_attention_fwd disagrees at the serving shape")
    kernel_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v,
                                                           causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                            causal=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound(
        card, b, h, t, t, d, True, dt)
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:119",
        "launches": None, "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": [b, h, t, d], "dtype": "bfloat16", "causal": True,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / kernel_ms / 1e9,
    }


def phase_attention_served():
    """The registered op served through InferenceServer: requests are
    fp32 (q, k, v) packs, cast to bf16 on the card inside the function."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, serving
    from mxnet_tpu_torch.ops import flash_attention as fa

    def attn(x):
        xb = x.astype("bfloat16")
        return nd.contrib.flash_attention(xb[:, 0], xb[:, 1], xb[:, 2],
                                          causal=True)

    item = (3, 16, 2048, 64)
    rng = np.random.default_rng(SEED)
    rows = [1, 2, 3, 1, 2, 3]
    reqs = [rng.standard_normal((r,) + item, dtype=np.float32) for r in rows]

    fa.LAUNCHES = 0  # the main path starts here
    srv = serving.InferenceServer(attn, item_shape=item, buckets=(1, 2, 4, 8),
                                  max_delay_ms=20, ctx=mx.gpu(0))
    try:
        check(srv.compile_count == 4, "warmup ran %d signatures, not 4"
              % srv.compile_count)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(srv.submit, reqs))
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    launches = fa.LAUNCHES  # read just after the path
    batches = srv.metrics.total_batches
    check(launches == 4 + batches,
          "flash_attention_fwd launched %d times for 4 warmup and %d served "
          "batches" % (launches, batches))
    for r, o in zip(rows, outs):
        check(o.shape == (r, 16, 2048, 64), "served shape %s" % (o.shape,))
        check(bool(torch.isfinite(o.data_.float()).all()),
              "non-finite served output")
    x = torch.from_numpy(reqs[2]).cuda().to(torch.bfloat16)
    ref, _ = fa.flash_attention_reference(
        x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2].contiguous(),
        causal=True)
    err = float((outs[2].data_.float() - ref.float()).abs().max())
    check(max_violation(outs[2].data_, ref, 1e-2, 1e-2) <= 0,
          "served attention disagrees with the plain version (%g)" % err)
    log(json.dumps({"phase": "attention_served", "requests": len(rows),
                    "rows": sum(rows), "batches": batches,
                    "launches": launches, "max_abs_err_vs_plain": err,
                    "wall_s": wall, "stats": srv.stats()}))
    return launches


def phase_resnet_served():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, serving
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.parameter import override
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.ops import flash_attention as fa

    log("tf32: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s (strict fp32 "
        "for the host comparison and the fp32 img/s)"
        % (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))
    fa.LAUNCHES = 0
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    item = (3, 224, 224)
    buckets = (1, 8, 32)

    def fp32_fn(x):
        return net(x)

    srv32 = serving.InferenceServer(fp32_fn, item_shape=item,
                                    buckets=buckets, max_delay_ms=5)
    pobjs = list(net.collect_params().values())
    bf16_params = [p.data().astype("bfloat16") for p in pobjs]

    def bf16_fn(*args):
        *weights, x = args
        with override(dict(zip(pobjs, weights))):
            return net(x.astype("bfloat16"))

    srv16 = serving.InferenceServer(bf16_fn, bf16_params, item_shape=item,
                                    buckets=buckets, max_delay_ms=5)
    rng = np.random.default_rng(SEED)
    rows = [1, 2, 3, 4, 1, 2, 3, 4]
    reqs = [rng.random((r,) + item, dtype=np.float32) for r in rows]
    result = {"phase": "resnet50_v1_served"}
    try:
        for tag, srv in (("fp32", srv32), ("bf16", srv16)):
            check(srv.compile_count == len(buckets),
                  "%s warmup ran %d signatures" % (tag, srv.compile_count))
            with ThreadPoolExecutor(len(reqs)) as pool:
                futs = list(pool.map(srv.submit, reqs))
            outs = [f.result(timeout=300) for f in futs]
            for r, o in zip(rows, outs):
                check(o.shape == (r, 1000), "served shape %s" % (o.shape,))
                check(bool(np.isfinite(o.asnumpy()).all()),
                      "non-finite %s output" % tag)
            result[tag] = {"batches": srv.metrics.total_batches,
                           "stats": srv.stats()}

        # fp32 on the card against the same net on the host.
        x2 = reqs[1]
        got32 = srv32.predict(x2).asnumpy()
        got16 = srv16.predict(x2).asnumpy()
        with mx.cpu():
            host = vision.resnet50_v1(classes=1000)
            host.initialize()
            params_from_numpy(host, {p.name: p.data().asnumpy()
                                     for p in pobjs}, prefix=net.prefix)
            with autograd.pause():
                want = host(nd.array(x2)).asnumpy()
        scale = float(np.abs(want).max())
        err32 = float(np.abs(got32 - want).max())
        rel16 = float(np.abs(got16 - want).max()) / scale
        result["host_check"] = {"images": 2, "max_abs_ref": scale,
                                "fp32_max_abs_err": err32,
                                "fp32_limit": 1e-3 * scale,
                                "bf16_rel_err": rel16}
        check(err32 <= 1e-3 * scale,
              "fp32 served output differs from the host run: %g > %g"
              % (err32, 1e-3 * scale))
        # bf16 keeps 8 mantissa bits through 53 layers; a loose check
        # that it computes the same function.
        check(rel16 <= 0.1, "bf16 output too far from fp32: %g" % rel16)

        # img/s at batch 32: the served function on a batch already on
        # the card (the bench's inference row), and end to end through
        # predict() with host requests.
        batch = nd.array(rng.random((32,) + item, dtype=np.float32),
                         ctx=mx.gpu(0))

        def forward(fn, params):
            with torch.no_grad(), autograd.pause():
                fn(*params, batch).wait_to_read()

        host32 = rng.random((32,) + item, dtype=np.float32)
        for tag, fn, params, srv in (("fp32", fp32_fn, [], srv32),
                                     ("bf16", bf16_fn, bf16_params, srv16)):
            ms = time_ms(lambda: forward(fn, params))
            t0 = time.perf_counter()
            for _ in range(ITERS):
                srv.predict(host32).wait_to_read()
            served_s = (time.perf_counter() - t0) / ITERS
            result[tag].update({"forward_ms_b32": ms,
                                "forward_img_s_b32": 32e3 / ms,
                                "served_ms_b32": served_s * 1e3,
                                "served_img_s_b32": 32 / served_s})
        torch.backends.cudnn.allow_tf32 = True
        ms = time_ms(lambda: forward(fp32_fn, []))
        torch.backends.cudnn.allow_tf32 = False
        result["fp32_tf32_conv"] = {"forward_ms_b32": ms,
                                    "forward_img_s_b32": 32e3 / ms}
    finally:
        srv32.shutdown()
        srv16.shutdown()
    result["flash_attention_launches"] = fa.LAUNCHES
    log(json.dumps(result))


def main():
    t_start = time.perf_counter()
    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    entry = phase_kernels(card)
    entry["launches"] = phase_attention_served()
    phase_resnet_served()
    entry["card"] = card_line
    log(json.dumps({"kernels": [entry]}))
    log("total_seconds", round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it drives mxnet_tpu_torch on "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
