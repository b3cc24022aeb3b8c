#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (no
phase falls back to the host or to a plain version):

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA source of the port, all at once (timed),
   with ptxas's register and spill report of each instantiation; a
   missing instantiation of an attention kernel, or a spill in one at
   head_dim 64 or 128, fails.
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs (fp32 at head dims 32, 64 and 128; bf16 and fp16, the
   tensor-core K1/K2/K3, at ragged and cross shapes, WGMMA_CASES; held to
   ``ops.flash_attention.kernel_tolerance``), and at the shape the main
   path gives it, where it is timed beside its plain version, the
   library call that computes the same function, and its bound: the
   forward (K1) at the serving shape, the backward (K2 dK/dV, K3 dQ) at
   the training shape, with the backward's peak memory held below one
   fp32 score matrix.
4. attention served: ``InferenceServer`` over
   ``nd.contrib.flash_attention`` (16 heads x 64, T 2048, causal, bf16).
5. ResNet-50 v1 served at full width (224x224, 1000 classes, buckets
   1/8/32) in fp32 and bf16; fp32 outputs against the same net on the
   host, and img/s at batch 32.
6. attention trained: ``TrainStep`` (bf16, fp32 masters) over
   ``examples.attention_layer.SelfAttention``, built from the public API
   (Dense 3072, 16 heads x 64 through ``F.contrib.flash_attention``,
   Dense 1024) at B 8, T 2048 with ``L2Loss`` to a fixed random target:
   K1, K2 and K3 launch once per step and the loss falls; one fp32 step
   at T 256 on the card against the same step on the host.
7. ResNet-50 v1 trained at full width: img/s at batch 32 through
   ``examples.train_imagenet.benchmark_rate`` in fp32 (TF32 off) and
   bf16, no flash-attention kernel launched; then, for three seeds, one
   step at batch 8 from the same weights in fp32 and float64 on the card
   and on the host: the float64 steps agree to float64 rounding, and the
   card's fp32 update is as close to the float64 one, tensor by tensor,
   as the host's fp32 update is (PARITY_LIMITS).

8. rtc direct (K4): ``rtc.CudaModule`` compiles ``csrc/rtc/*.cu`` with
   NVRTC for sm_90a (compile time and cache counts logged); scale_add
   launched through the CudaKernel API on the JAX fixture's (1, 8) and
   at 4096x4096, and relu as the rtc kernel of a partitioned dense-relu
   MLP (b32, 1024 -> 4096 -> 1000), each exact against its plain version;
   then (not counted) scale_add on views one element past a 16-byte
   boundary at an odd n, through CudaKernel.launch and the wrapper.
9. rtc kernels: scale_add and relu timed beside their plain versions,
   torch calls (device time and back-to-back) and bounds, relu also at
   4096x4096; fused BatchNorm(inference)+ReLU at each
   distinct ResNet-50 v1 b32 shape against its plain version (rtol 1e-5
   + 1e-6 max|want|), timed beside it, ``F.batch_norm`` + ``F.relu``
   and its bytes bound; its two-output variant held at one shape; the
   host cost of one ``CudaKernel.launch``. The rtc rows are timed with
   the card kept ahead of the host (time_queued: device time), and the
   kernels also as back-to-back calls (``ms_host_window``).
10. ResNet-50 v1 served from a checkpoint: the gluon net (BatchNorm
   statistics randomized) is exported and served through
   ``InferenceServer.from_checkpoint`` (fp32, TF32 off, buckets
   1/8/32), plain and with ``MXNET_SUBGRAPH_BACKEND=fused_bn_relu``;
   requests of 1, 5 and 32 rows at once; ``compile_count`` is the
   number of buckets; the fused kernel launches exactly 33 times per
   forward (warmup included) under the partition and 0 times without;
   both servers and the hybridized gluon net agree within 1e-5 of the
   largest logit; img/s at b32 on a batch on the card and through
   ``predict()``.
11. ResNet-50 v1 trained through ``gluon.Trainer`` (the usual MXNet
   loop: ``autograd.record``, ``backward``, ``trainer.step(32)``;
   hybridized; SGD lr 0.1, momentum 0.9, wd 1e-4) at full width, b32:
   img/s as ``benchmark_rate`` times it, fp32 (TF32 off) and bf16
   (``net.cast("bfloat16")``, ``multi_precision``); the optimizer's
   launches and device time per ``step`` (torch.profiler) with
   ``fused=True`` and ``fused=False``; from one state, on the same
   gradients, one fused step equal to one loop step bit for bit
   (weights and optimizer states of all 161 trainable tensors, fp32 and
   bf16+mp, two steps); ``save_states`` after 2 steps and
   ``load_states`` into a fresh Trainer, then 2 more steps equal to 4
   uninterrupted steps bit for bit. No flash-attention kernel runs. Phase
   7's parity also holds one Trainer step against the float64 step
   with the fp32 terms of PARITY_LIMITS, and prints whether it equals
   the TrainStep step bit for bit.
12. the attention layer of phase 6 trained through ``gluon.Trainer``
   (adam lr 1e-3, ``multi_precision``, bf16 weights) for 10 steps on one
   batch: K1, K2 and K3 launch once per step, the loss falls; step ms.
13. input pipeline: 512 PNG records of 256x256x3 noise (labels in
   [0, 1000)) and their .idx written with the port's ``recordio``;
   ``DataPipeline`` (4 decode threads, prefetch 2, ``place=True``: pinned
   staging and a side-stream copy to gpu(0)) and ``ImageRecordIter``,
   center crop to 224 and mean/std normalization, each batch on the card
   read back before and after a b32 fp32 ResNet-50 ``TrainStep`` on it and
   held bit for bit against the same source's host pass; the pipeline's
   img/s at 1, 4 and 8 decode threads (random crop and mirror); one
   19.27 MB batch's upload, pinned against pageable, beside the PCIe
   link's bound; ResNet-50 v1 b32 train img/s fed by the pipeline (fp32,
   bf16) and, bf16, by a 4-worker process-pool ``DataLoader``, beside
   phase 7's synthetic img/s, with the data-wait share and
   ``stall_fraction`` of each; the gluon loop (``DataLoader`` with 0 and
   4 workers and ``pin_memory``, ``gluon.Trainer``) at its own
   configuration, its loss falling. The native RecordIO reader must be
   the one that read the records; no kernel of the port launches.
14. checkpoint: ResNet-50 v1 at full width (b32, SGD lr 0.1, momentum
   0.9, wd 1e-4, random weights from seed 0) through
   ``mxnet_tpu_torch.checkpoint``: the bytes of a TrainStep
   ``state_dict``; fp32 TrainStep img/s (benchmark_rate's windows) with
   no saves, an async ``CheckpointManager.save`` every step and every 10
   steps, and no saves again (``keep_last=2`` in a temporary directory,
   whose free space and filesystem type are printed), with the
   ``checkpoint::snapshot`` ms, the writer's MB/s, write and commit ms
   and ``dropped_saves``, beside a pageable copy of the same state; 4
   TrainStep steps saved each, step 2 restored into a fresh step and 2
   more steps equal to the 4 uninterrupted steps bit for bit (cuDNN
   deterministic; the uninterrupted run repeated as a control); the same
   for a bf16 net with ``multi_precision`` through ``gluon.Trainer``
   (``checkpoint.state_dict`` of net and trainer; the restored weights
   are bfloat16; its state's bytes); a SIGTERM sent from inside a step's
   update loop commits the pre- or post-step state bit for bit; and
   ``examples.train_resume`` SIGTERMed mid-run in a child process,
   restarted, with the same final digest as an uninterrupted run.
15. Module: the same ResNet-50 v1 exported, with
   ``SoftmaxOutput(name="softmax")``, trained through ``Module.fit`` over
   an ``NDArrayIter`` of synthetic b32 batches (fp32, TF32 off; the
   default ``acc`` metric): img/s in benchmark_rate's windows beside
   phase 11's Trainer, and the peak memory of a batch beside the
   Trainer's; one step at batch 8 from the same weights through a
   float64 Module and ``TrainStep(dtype="float64")`` held to
   PARITY_LIMITS' float64 terms; ``module_checkpoint`` after epoch 1,
   ``Module.load`` and ``fit(begin_epoch=1)`` equal to the uninterrupted
   two epochs bit for bit.

Each path (4, 6, 7, 8, 10, 11, 12, 13, 14, 15) is driven with every
launch count set to 0 just before it and read just after. Then one ``{"kernels": [...]}`` line and,
last, one ``{"ok": true, "device": {...}}`` line. The weights are
random, from a seed. The K1-K3 rows' ``ms``, ``plain_ms`` and
``library_ms`` are CUDA-event medians of 20 single calls after warmup
(``time_ms``), the wrapper's host cost inside the window; their
``device_ms`` and ``library_device_ms`` are device time, the median of 5
windows of 20 calls queued behind a sleep kernel (``time_queued``). The
rtc rows' ``ms`` is ``time_queued`` and their ``ms_host_window`` the
median of back-to-back calls.
"""
from __future__ import annotations

import json
import re
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


def time_each(fn, reps=10):
    """Median CUDA-event time of one `fn` in milliseconds, from windows
    of `reps` back-to-back calls: a short kernel's host launch cost then
    overlaps the kernels queued before it, as on a served path."""
    def window():
        for _ in range(reps):
            fn()

    return time_ms(window) / reps


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms():
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def time_queued(fn, reps=20, iters=5):
    """Median device time of one `fn` in milliseconds, with the card
    kept ahead of the host: a sleep kernel holds the stream while `reps`
    calls are queued behind the start event, so the window times the
    card running them back to back, not the host's launch cost (which
    bounds time_each for kernels shorter than a launch). A window the
    card reached before the host had queued it all is run again with a
    longer sleep."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms() * (2 * host_ms + 1))
    times = []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card still sleeping: all queued
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / reps)
        else:
            check(cycles < 1e11, "time_queued: the host never got ahead")
            cycles *= 2
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


def backward_bound(card, b, h, tq, tk, d, causal, dtype, which):
    """Least time (ms) for one backward kernel's work: K2 ("dkv") does
    8 and K3 ("dq") 6 FLOP per (query, key, head-dim) triple (two dot
    products and two or one updates), halved for causal; bytes are Q,
    K, V, dO read and the fp32 LSE and delta, plus dK and dV (K2) or dQ
    (K3) written, each once."""
    peaks = PEAKS["H200" if "H200" in card else "H100"]
    elt = torch.tensor([], dtype=dtype).element_size()
    per = 8.0 if which == "dkv" else 6.0
    flops = per * b * h * tq * tk * d * (0.5 if causal and tq == tk
                                         else 1.0)
    reads = (2 * tq + 2 * tk) * b * h * d * elt + 2 * 4 * b * h * tq
    writes = (2 * tk if which == "dkv" else tq) * b * h * d * elt
    nbytes = reads + writes
    t_ops = flops / peaks[str(dtype).split(".")[1]]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def max_violation(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _relative(arrays, prefix):
    """{relative name: array}: parameter names without the net's prefix
    and with block counters renumbered, so two nets built in one process
    match (gluon.utils.relative_names)."""
    from mxnet_tpu_torch.gluon.utils import relative_names

    rel = relative_names(list(arrays), prefix)
    return {rel[n]: v for n, v in arrays.items()}


def _step_state_errors(card_state, host_state, w0):
    """Per tensor, max |(card - w0) - (host - w0)| / max |host - w0|: the
    error of the card's update relative to the host's."""
    out = {}
    for n, host in host_state.items():
        step = host - w0[n]
        scale = float(np.abs(step).max())
        out[n] = float(np.abs(card_state[n] - host).max()) / max(scale,
                                                                  1e-30)
    return out


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


# Every attention kernel of the port, as ptxas names its instantiations
# (mangled: the name, then the template arguments: the dtype, where the
# kernel has one, and the head dim).
ATTENTION_KERNELS = {
    "flash_fwd_kernel": ("f",),
    "flash_fwd_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
    "flash_bwd_dkv_kernel": ("f",),
    "flash_bwd_dkv_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
    "flash_bwd_dq_kernel": ("f",),
    "flash_bwd_dq_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
}


def _instantiation(entry):
    """(kernel, dtype, head_dim) of a mangled attention entry, or None."""
    m = re.search(r"\d+(flash_\w+?_kernel)I(f|13__nv_bfloat16|6__half)?"
                  r"Li(\d+)E", entry or "")
    if not m or m.group(1) not in ATTENTION_KERNELS:
        return None
    return m.group(1), m.group(2) or "f", int(m.group(3))


def phase_build():
    """Build every source; fail on a missing attention instantiation or
    on a spill in any attention kernel at head dim 64 or 128 (the dims
    the attention layers run)."""
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    _native.build()
    seconds = time.perf_counter() - t0
    spills, seen = [], set()
    for name in _native.SOURCES:
        lines = _native.build_log(name).splitlines()
        regs = [ln.strip() for ln in lines if "registers" in ln]
        log("built %s: %d kernel instantiations" % (name, len(regs)))
        entry = None
        for ln in lines:
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
                inst = _instantiation(entry)
                if inst:
                    seen.add(inst)
            elif "registers" in ln:
                log("  ", _instantiation(entry) or entry, ln.strip())
            elif "spill" in ln and \
                    "0 bytes spill stores, 0 bytes spill loads" not in ln:
                log("   spills in %s: %s" % (entry, ln.strip()))
                inst = _instantiation(entry)
                if inst and inst[2] in (64, 128):
                    spills.append("%s: %s" % (inst, ln.strip()))
    want = {(k, t, d) for k, types in ATTENTION_KERNELS.items()
            for t in types for d in (32, 64, 128)}
    log("build_seconds", round(seconds, 3))
    check(want <= seen, "attention instantiations missing from the ptxas "
          "report: %s" % sorted(want - seen))
    check(not spills, "ptxas reports register spills at head_dim 64/128:"
          "\n" + "\n".join(spills))


# bf16/fp16 cases of the tensor-core kernels (K1, K2, K3): the training
# geometry at head dims 64 and 128, non-causal T 2048 (where P's rounding
# to the dtype shows most), ragged T (200, 1000: no multiple of a 64- or
# 128-row tile), Tq 256 against Tk 512, and head dim 32 (64-byte
# swizzle), causal and not.
WGMMA_CASES = [
    ((2, 16, 2048, 64), (2, 16, 2048, 64), True),
    ((2, 16, 2048, 128), (2, 16, 2048, 128), True),
    ((1, 4, 2048, 64), (1, 4, 2048, 64), False),
    ((2, 3, 200, 64), (2, 3, 200, 64), True),
    ((1, 4, 1000, 128), (1, 4, 1000, 128), False),
    ((1, 4, 1000, 64), (1, 4, 1000, 64), True),
    ((1, 4, 256, 64), (1, 4, 512, 64), True),
    ((1, 4, 256, 128), (1, 4, 512, 128), False),
    ((2, 3, 200, 32), (2, 3, 200, 32), True),
    ((1, 4, 1000, 32), (1, 4, 1000, 32), False),
    ((1, 4, 256, 32), (1, 4, 512, 32), True),
]

# The kernel each dtype runs (the kernels line names it per entry).
DESIGN = {
    "flash_attention_fwd": {"bfloat16": "wgmma+tma", "float16": "wgmma+tma",
                            "float32": "ffma"},
    "flash_attention_bwd_dkv": {"bfloat16": "wgmma+tma",
                                "float16": "wgmma+tma", "float32": "ffma"},
    "flash_attention_bwd_dq": {"bfloat16": "wgmma+tma",
                               "float16": "wgmma+tma", "float32": "ffma"},
}


def phase_kernels(card):
    """Flash-attention forward kernel against its plain version."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(shape_q, shape_k, dtype):
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in (shape_q, shape_k, shape_k))

    # Tolerances: fa.kernel_tolerance; LSE is fp32 in both versions.
    cases = [
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, True),
    ]
    cases += [(sq, sk, dt, causal) for dt in (torch.bfloat16, torch.float16)
              for sq, sk, causal in WGMMA_CASES]
    launches0 = fa.LAUNCHES
    calls = 0
    by_dtype = {}
    for shape_q, shape_k, dt, causal in cases:
        q, k, v = inputs(shape_q, shape_k, dt)
        blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              **blocks)
        calls += 1
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        causal=causal,
                                                        **blocks)
        rtol, atol = fa.kernel_tolerance(dt, ref_out)
        _fold_error(by_dtype, dt, out, ref_out, rtol, atol)
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
    check(max_violation(out, ref_out, *fa.kernel_tolerance(dt, ref_out))
          <= 0,
          "flash_attention_fwd disagrees at the serving shape")
    # One call at a time (time_ms), the wrapper's host cost (checks,
    # three tensor maps) inside the window; and device time
    # (time_queued), which at a quarter of a millisecond differs.
    def kernel():
        return fa.flash_attention_forward(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    kernel_ms, device_ms = time_ms(kernel), time_queued(kernel)
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                            causal=True))
    library_ms, library_device_ms = time_ms(library), time_queued(library)
    bound_ms, bound_by, flops, nbytes = attention_bound(
        card, b, h, t, t, d, True, dt)
    # The fp32 (FFMA) kernel at the same shape: the design every dtype
    # ran before the tensor-core kernel.
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fp32_ms = time_ms(lambda: fa.flash_attention_forward(q32, k32, v32,
                                                         causal=True))
    del q32, k32, v32
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:119",
        "launches": None, "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "design": DESIGN["flash_attention_fwd"],
        "fp32_ms": fp32_ms,
        "bound_share": bound_ms / kernel_ms,
        "max_abs_err_by_dtype": by_dtype,
        "shape": [b, h, t, d], "dtype": "bfloat16", "causal": True,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / kernel_ms / 1e9,
    }


def _fold_error(by_dtype, dtype, got, want, rtol, atol):
    """Folds one comparison into {dtype: {max_abs_err, max_share}}:
    max_share is the largest |err| / (atol + rtol |want|) seen, the
    fraction of the tolerance used."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    cur = by_dtype.setdefault(str(dtype).split(".")[1],
                              {"max_abs_err": 0.0, "max_share": 0.0})
    cur["max_abs_err"] = max(cur["max_abs_err"], float(err.max()))
    cur["max_share"] = max(cur["max_share"], share)


def _hold_backward(names, got, want, errs, where):
    """Log and hold each gradient against its plain version
    (``kernel_tolerance``); folds the largest errors into `errs`. True
    if all are within."""
    from mxnet_tpu_torch.ops.flash_attention import kernel_tolerance

    res = {}
    for name, g_, w in zip(names, got, want):
        rtol, atol = kernel_tolerance(w.dtype, w)
        res[name] = (float((g_.float() - w.float()).abs().max()),
                     max_violation(g_, w, rtol, atol), rtol, atol)
    errs["dq"] = max(errs["dq"], res["dq"][0])
    errs["dkv"] = max(errs["dkv"], res["dk"][0], res["dv"][0])
    within = all(r[1] <= 0 for r in res.values())
    log(json.dumps(dict(
        {"check": "flash_attention_bwd (K2, K3) vs plain",
         "dtype": str(want[0].dtype).split(".")[1]}, **where,
        max_abs_err={n: r[0] for n, r in res.items()},
        tol={n: [r[2], r[3]] for n, r in res.items()}, within=within)))
    return within


def phase_backward_kernels(card):
    """K2 (dK/dV) and K3 (dQ), through the autograd.Function, against
    the plain backward; peak memory; timings at the training shape."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(shape_q, shape_k, dtype):
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in (shape_q, shape_k, shape_k, shape_q))

    # Tolerances: fa.kernel_tolerance. fp32 at every head dim the kernels
    # take (each has its own lanes per row), bf16/fp16 at the training
    # geometry.
    cases = [
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 128), (1, 4, 512, 128), torch.float32, True),
        ((1, 4, 256, 128), (1, 4, 512, 128), torch.float32, False),
        ((1, 4, 512, 32), (1, 4, 512, 32), torch.float32, True),
    ]
    cases += [(sq, sk, dt, causal) for dt in (torch.bfloat16, torch.float16)
              for sq, sk, causal in WGMMA_CASES]
    errs = {"dkv": 0.0, "dq": 0.0}
    by_dtype = {"dkv": {}, "dq": {}}
    for shape_q, shape_k, dt, causal in cases:
        q, k, v, g = inputs(shape_q, shape_k, dt)
        blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        fa.flash_attention(*leaves, causal=causal, **blocks).backward(g)
        torch.cuda.synchronize()
        check((fa.LAUNCHES_BWD_DKV - before[0], fa.LAUNCHES_BWD_DQ
               - before[1]) == (1, 1), "backward did not launch K2 and K3 "
              "once each")
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              **blocks)
        want = fa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                     causal=causal, **blocks)
        for which, got_w, want_w in (("dq", leaves[0].grad, want[0]),
                                     ("dkv", leaves[1].grad, want[1]),
                                     ("dkv", leaves[2].grad, want[2])):
            _fold_error(by_dtype[which], dt, got_w, want_w,
                        *fa.kernel_tolerance(dt, want_w))
        within = _hold_backward(("dq", "dk", "dv"),
                                [t.grad for t in leaves], want, errs,
                                dict(q=shape_q, k=shape_k, causal=causal))
        check(within, "backward kernels disagree with the plain version at "
              "%s/%s %s causal=%s" % (shape_q, shape_k, dt, causal))

    # The training shape of the attention layer.
    b, h, t, d, dt = 8, 16, 2048, 64, torch.bfloat16
    q, k, v, g = inputs((b, h, t, d), (b, h, t, d), dt)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    delta = (g.float() * out.float()).sum(-1).contiguous()
    torch.cuda.synchronize()
    score_bytes = 4 * b * h * t * t
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.flash_attention_backward(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(json.dumps({"check": "backward peak memory", "shape": [b, h, t, d],
                    "peak_bytes_above_inputs": peak,
                    "fp32_score_matrix_bytes": score_bytes}))
    check(peak < score_bytes, "backward peak memory %d >= one fp32 score "
          "matrix %d" % (peak, score_bytes))

    # K2 and K3 at this shape against their plain versions.
    got_dk, got_dv = fa.launch_bwd_dkv(q, k, v, g, lse, delta, True,
                                       d ** -0.5)
    got_dq = fa.launch_bwd_dq(q, k, v, g, lse, delta, True, d ** -0.5)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, out, lse, g, causal=True)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse, g,
                                                  causal=True)
    within = _hold_backward(("dq", "dk", "dv"), (got_dq, got_dk, got_dv),
                            (want_dq, want_dk, want_dv), errs,
                            dict(q=[b, h, t, d], k=[b, h, t, d],
                                 causal=True, launched="directly"))
    check(within, "backward kernels disagree with the plain version at the "
          "training shape")
    del got_dk, got_dv, got_dq, want_dk, want_dv, want_dq

    # One call at a time and device time, as for K1.
    def dkv():
        return fa.launch_bwd_dkv(q, k, v, g, lse, delta, True, d ** -0.5)

    def dq():
        return fa.launch_bwd_dq(q, k, v, g, lse, delta, True, d ** -0.5)

    dkv_ms, dq_ms = time_ms(dkv), time_ms(dq)
    device_ms = {"dkv": time_queued(dkv), "dq": time_queued(dq)}
    plain_dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
        q, k, v, out, lse, g, causal=True), iters=5)
    plain_dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, g, causal=True), iters=5)
    # Yardstick, never called by the port: the backward of PyTorch's
    # fused attention (dq, dk and dv in one call) on a retained graph.
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    def library():
        return torch.autograd.grad(lib_out, (lq, lk, lv), g,
                                   retain_graph=True)

    library_ms, library_device_ms = time_ms(library), time_queued(library)
    # The fp32 (FFMA) kernels at the same shape, as for K1.
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    fp32_ms = {
        "dkv": time_ms(lambda: fa.launch_bwd_dkv(
            q32, k32, v32, g32, lse, delta, True, d ** -0.5)),
        "dq": time_ms(lambda: fa.launch_bwd_dq(
            q32, k32, v32, g32, lse, delta, True, d ** -0.5))}
    del q32, k32, v32, g32
    entries = []
    for name, which, ms, plain_ms, replaces in (
            ("flash_attention_bwd_dkv", "dkv", dkv_ms, plain_dkv_ms,
             "mxnet_tpu/ops/pallas_attention.py:262"),
            ("flash_attention_bwd_dq", "dq", dq_ms, plain_dq_ms,
             "mxnet_tpu/ops/pallas_attention.py:281")):
        bound_ms, bound_by, flops, nbytes = backward_bound(
            card, b, h, t, t, d, True, dt, which)
        entries.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[which], "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms[which],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library_call": "backward of F.scaled_dot_product_attention "
                            "(dq, dk and dv together)",
            "design": DESIGN[name], "fp32_ms": fp32_ms[which],
            "bound_share": bound_ms / ms,
            "max_abs_err_by_dtype": by_dtype[which],
            "shape": [b, h, t, d], "dtype": "bfloat16", "causal": True,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / ms / 1e9,
            "backward_peak_bytes": peak})
    return entries


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
    check(max_violation(outs[2].data_, ref,
                        *fa.kernel_tolerance(ref.dtype, ref)) <= 0,
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


def _reset_launches():
    from mxnet_tpu_torch.ops import flash_attention as fa

    fa.LAUNCHES = fa.LAUNCHES_BWD_DKV = fa.LAUNCHES_BWD_DQ = 0


def _launches():
    from mxnet_tpu_torch.ops import flash_attention as fa

    return fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ


def phase_attention_trained():
    """TrainStep over the attention block: bf16 at B 8, T 2048 (the
    main path: K1, K2, K3 once per step, the loss falls), then one fp32
    step at T 256 on the card against the same step on the host."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    units, steps = 1024, 8
    opt = {"learning_rate": 10.0, "momentum": 0.9}

    def build(ctx):
        mx.random.seed(SEED)
        net = SelfAttention(units, heads=16)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        return net

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((8, 2048, units),
                                             dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal((8, 2048, units),
                                             dtype=np.float32)).cuda()
    net = build(mx.gpu(0))
    step = TrainStep(net, gluon.loss.L2Loss(), "sgd", opt,
                     mesh=make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
                     dtype="bfloat16")
    losses, per_step, times = [], [], []
    _reset_launches()  # the main path starts here
    for _ in range(steps):
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(x, y))
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(_launches(), before)))
    launches = _launches()  # read just after the path
    check(all(c == (1, 1, 1) for c in per_step),
          "K1/K2/K3 launches per step %s, not once each" % per_step)
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)

    # One fp32 step, card against host, from the same numpy weights.
    xs = rng.standard_normal((2, 256, units), dtype=np.float32)
    ys = rng.standard_normal((2, 256, units), dtype=np.float32)
    card_net = build(mx.gpu(0))
    w0 = {p.name: p.data().asnumpy()
          for p in card_net.collect_params().values()}
    with mx.cpu():
        host_net = SelfAttention(units, heads=16)
        host_net.initialize(ctx=mx.cpu())
        params_from_numpy(host_net, w0, prefix=card_net.prefix)
    results = {}
    for tag, n, ctx in (("card", card_net, mx.gpu(0)),
                        ("host", host_net, mx.cpu())):
        st = TrainStep(n, gluon.loss.L2Loss(), "sgd", opt,
                       mesh=make_mesh({"dp": 1}, devices=[ctx]))
        loss = float(st(xs, ys))
        results[tag] = (loss, _relative(st.state_to_host()[0], n.prefix))
    w0 = _relative(w0, card_net.prefix)
    loss_err = abs(results["card"][0] - results["host"][0]) / \
        abs(results["host"][0])
    step_errs = _step_state_errors(results["card"][1], results["host"][1],
                                   w0)
    log(json.dumps({
        "phase": "attention_trained", "shape": [8, 16, 2048, 64],
        "dtype": "bfloat16", "steps": steps, "losses": losses,
        "step_ms": times, "step_ms_median": float(np.median(times[2:])),
        "launches_per_step": per_step, "launches": launches,
        "fp32_step_card_vs_host": {
            "shape": [2, 16, 256, 64], "loss_card": results["card"][0],
            "loss_host": results["host"][0], "loss_rel_err": loss_err,
            "update_rel_err": step_errs, "limits": [1e-5, 1e-3]}}))
    # fp32 on both sides, no kinks in the block: the card's loss within
    # 1e-5 relative, each weight's update within 1e-3 of its largest
    # entry (summation order only).
    check(loss_err < 1e-5, "fp32 attention loss card %r vs host %r"
          % (results["card"][0], results["host"][0]))
    check(max(step_errs.values()) < 1e-3,
          "fp32 attention update card vs host: %s" % step_errs)
    return launches, float(np.median(times[2:]))


def phase_resnet_trained():
    """ResNet-50 v1 training: img/s at b32 (fp32 TF32 off, bf16) through
    the port's train_imagenet driver, then one step's parity over
    PARITY_SEEDS (see _resnet_parity)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_imagenet

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    _reset_launches()  # the main path starts here
    mx.random.seed(SEED)
    result = {"phase": "resnet50_v1_trained", "batch": 32, "windows": 5,
              "iters_per_window": 16}
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        t0 = time.perf_counter()
        rate = train_imagenet.benchmark_rate("resnet50", 32, dtype,
                                             device=mx.gpu(0))
        result[tag] = {"img_s_b32": rate,
                       "ms_per_step": 32e3 / rate,
                       "phase_s": time.perf_counter() - t0}
    launches = _launches()  # read just after the path
    result["flash_attention_launches"] = launches
    check(launches == (0, 0, 0), "ResNet-50 training launched flash "
          "attention kernels %s" % (launches,))

    result["parity"] = [_resnet_parity(seed) for seed in PARITY_SEEDS]
    log(json.dumps(result))
    for reading in result["parity"]:
        check(reading["within"], "ResNet-50 step parity failed at seed %d: "
              "%s" % (reading["seed"], reading["failed"]))
    return result


# ResNet-50 step parity: seeds of the weights and data, batch, and limits.
# Forward quantities are smooth: the fp32 loss and running stats agree
# with the float64 step to fp32 summation order. The float64 step on the
# card and on the host is the same function up to float64 rounding, and
# its fp32 masters round the same update (momentum within 1e-5 of the
# tensor's largest entry, weights within two fp32 roundings plus 1e-5 of
# the largest update). An fp32 update is held tensor by tensor against
# the float64 one as closely as the host's own fp32 update is: a ReLU
# input within fp32 rounding of zero takes the other side in one run or
# the other and moves the gradients upstream of it. The fp32 limits are
# set from readings over these seeds on an H100 (PERF.md, Findings): per
# tensor the card's error was at most 3.4 times the host's, over the net
# (relative L2) at most 1.04 times.
PARITY_SEEDS = (0, 1, 2)
PARITY_BATCH = 8
PARITY_LIMITS = {"f64_loss": 1e-9, "f64_momentum": 1e-5, "f64_aux": 1e-6,
                 "f64_weight_rtol": 2.0 ** -22, "f64_weight_step": 1e-5,
                 "fp32_loss": 1e-4, "fp32_aux": 1e-4,
                 "fp32_update_ratio": 4.0, "fp32_update_floor": 1e-3,
                 "fp32_update_l2_ratio": 1.5}


def _rel_max(got, want):
    """Per tensor, max |got - want| / max |want|."""
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-30) for n, w in want.items()}


def _rel_l2(got, want):
    """Relative L2 error over every tensor of a {name: array} state."""
    num = sum(float(np.sum((got[n] - w) ** 2)) for n, w in want.items())
    den = sum(float(np.sum(w ** 2)) for w in want.values())
    return (num / den) ** 0.5


def _trainer_parity_run(w0, prefix, xs, ys, opt):
    """One gluon.Trainer step (hybridized, fused) of ResNet-50 v1 on the
    card from the weights `w0`: the run dict _resnet_parity compares."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    t0 = time.perf_counter()
    net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mx.gpu(0))
    params_from_numpy(net, w0, prefix=prefix)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    loss = _record_and_backward(net, nd.array(xs, ctx=mx.gpu(0)),
                                nd.array(ys, ctx=mx.gpu(0)))
    trainer.step(xs.shape[0])
    params = list(net.collect_params().values())
    states = trainer._updater.states
    train = {p.name: p.data().asnumpy() for p in params
             if p.grad_req != "null"}
    mom = {p.name: states[i].asnumpy() for i, p in enumerate(params)
           if p.grad_req != "null"}
    aux = {p.name: p.data().asnumpy() for p in params
           if p.grad_req == "null"}
    check(trainer._applier.num_compiles >= 1, "the parity Trainer step did "
          "not take the fused path")
    return {"loss": float(loss.asnumpy().mean()),
            "w": _relative(train, net.prefix),
            "mom": _relative(mom, net.prefix),
            "aux": _relative(aux, net.prefix),
            "seconds": time.perf_counter() - t0}


def _resnet_parity(seed):
    """One SGD-momentum-wd step of ResNet-50 v1 at PARITY_BATCH from one
    set of weights: fp32 and float64 on the card, fp32 on the host, and
    (first seed) float64 on the host; held to PARITY_LIMITS. The same
    step through gluon.Trainer on the card (``card_trainer``) is held to
    the fp32 terms, and compared with the TrainStep step bit for bit
    (printed, not held: cuDNN may pick nondeterministic algorithms)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    lim = PARITY_LIMITS
    rng = np.random.default_rng(seed)
    xs = rng.random((PARITY_BATCH, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}

    def train_step(net, ctx, dtype):
        return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                         opt, mesh=make_mesh({"dp": 1}, devices=[ctx]),
                         dtype=dtype)

    mx.random.seed(seed)
    card_net = vision.resnet50_v1(classes=1000)
    card_net.initialize(mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
                        ctx=mx.gpu(0))
    runs = {"card_fp32": train_step(card_net, mx.gpu(0), None)}
    runs["card_fp32"]._materialize(torch.from_numpy(xs[:1]))
    w0 = {p.name: p.data().asnumpy()
          for p in card_net.collect_params().values()}
    runs["card_f64"] = train_step(card_net, mx.gpu(0), "float64")
    hosts = [("host_fp32", None)]
    if seed == PARITY_SEEDS[0]:
        hosts.append(("host_f64", "float64"))
    for tag, dtype in hosts:
        with mx.cpu():
            net = vision.resnet50_v1(classes=1000)
            net.initialize(ctx=mx.cpu())
            params_from_numpy(net, w0, prefix=card_net.prefix)
        runs[tag] = train_step(net, mx.cpu(), dtype)
    out = {}
    for tag, st in runs.items():
        t0 = time.perf_counter()
        loss = float(st(xs, ys))
        params, states, aux = st.state_to_host()
        pre = st.net.prefix
        out[tag] = {"loss": loss, "w": _relative(params, pre),
                    "mom": _relative({n: s[0] for n, s in states.items()},
                                     pre),
                    "aux": _relative(aux, pre),
                    "seconds": time.perf_counter() - t0}
        del st
    runs.clear()
    out["card_trainer"] = _trainer_parity_run(w0, card_net.prefix, xs, ys,
                                              opt)
    w0 = _relative(w0, card_net.prefix)
    ref = out["card_f64"]
    failed = []

    def hold(name, value, limit):
        if not value <= limit:
            failed.append("%s %g > %g" % (name, value, limit))

    reading = {"seed": seed, "batch": PARITY_BATCH,
               "step_seconds": {t: o["seconds"] for t, o in out.items()},
               "loss": {t: o["loss"] for t, o in out.items()}}
    if "host_f64" in out:
        host = out["host_f64"]
        mom = _rel_max(ref["mom"], host["mom"])
        aux = _rel_max(ref["aux"], host["aux"])
        weight_excess = max(
            float((np.abs(ref["w"][n] - w) - lim["f64_weight_rtol"]
                   * np.abs(w)).max())
            / max(float(np.abs(w - w0[n]).max()), 1e-30)
            for n, w in host["w"].items())
        loss = abs(ref["loss"] - host["loss"]) / abs(host["loss"])
        reading["card_f64_vs_host_f64"] = {
            "loss_rel": loss, "momentum_rel_max": max(mom.values()),
            "aux_rel_max": max(aux.values()),
            "weight_excess_over_step": weight_excess}
        hold("f64 loss", loss, lim["f64_loss"])
        hold("f64 momentum", max(mom.values()), lim["f64_momentum"])
        hold("f64 running stats", max(aux.values()), lim["f64_aux"])
        hold("f64 weights", weight_excess, lim["f64_weight_step"])
    errs = {}
    for tag in ("card_fp32", "host_fp32", "card_trainer"):
        o = out[tag]
        errs[tag] = _rel_max(o["mom"], ref["mom"])
        loss = abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
        aux = max(_rel_max(o["aux"], ref["aux"]).values())
        e = sorted(errs[tag].values())
        reading[tag + "_vs_card_f64"] = {
            "loss_rel": loss, "aux_rel_max": aux,
            "momentum_rel_l2": _rel_l2(o["mom"], ref["mom"]),
            "momentum_rel_median": e[len(e) // 2],
            "momentum_rel_max": e[-1]}
        hold(tag + " loss", loss, lim["fp32_loss"])
        hold(tag + " running stats", aux, lim["fp32_aux"])
    excess = {n: errs["card_fp32"][n] - lim["fp32_update_ratio"]
              * errs["host_fp32"][n] for n in errs["card_fp32"]}
    worst = sorted(excess, key=lambda n: -excess[n])[:5]
    reading["fp32_update_worst"] = [
        [n, errs["card_fp32"][n], errs["host_fp32"][n]] for n in worst]
    ratios = sorted(errs["card_fp32"][n] / max(errs["host_fp32"][n], 1e-30)
                    for n in errs["card_fp32"])
    reading["fp32_update_ratio_quantiles"] = [
        ratios[int(q * (len(ratios) - 1))] for q in (0.5, 0.9, 1.0)]
    hold("fp32 update of %s over %g x host's" % (worst[0],
                                                 lim["fp32_update_ratio"]),
         excess[worst[0]], lim["fp32_update_floor"])
    hold("fp32 update over the net against host's",
         reading["card_fp32_vs_card_f64"]["momentum_rel_l2"]
         / reading["host_fp32_vs_card_f64"]["momentum_rel_l2"],
         lim["fp32_update_l2_ratio"])
    # The Trainer's step, held to the same fp32 terms.
    t_excess = {n: errs["card_trainer"][n] - lim["fp32_update_ratio"]
                * errs["host_fp32"][n] for n in errs["card_trainer"]}
    t_worst = max(t_excess, key=lambda n: t_excess[n])
    hold("Trainer fp32 update of %s over %g x host's"
         % (t_worst, lim["fp32_update_ratio"]), t_excess[t_worst],
         lim["fp32_update_floor"])
    hold("Trainer fp32 update over the net against host's",
         reading["card_trainer_vs_card_f64"]["momentum_rel_l2"]
         / reading["host_fp32_vs_card_f64"]["momentum_rel_l2"],
         lim["fp32_update_l2_ratio"])
    tr, ts = out["card_trainer"], out["card_fp32"]
    reading["trainer_equals_train_step_bitwise"] = {
        "weights": all(np.array_equal(tr["w"][n], ts["w"][n])
                       for n in ts["w"]),
        "momentum": all(np.array_equal(tr["mom"][n], ts["mom"][n])
                        for n in ts["mom"]),
        "loss": tr["loss"] == ts["loss"]}
    reading["limits"] = lim
    reading["failed"] = failed
    reading["within"] = not failed
    log(json.dumps({"check": "ResNet-50 step parity", **reading}))
    return reading



# -- slice 3: K4, rtc.CudaModule over NVRTC ----------------------------------

def _bytes_bound(card, nbytes):
    """Least time (ms) to move `nbytes` once at the card's memory rate;
    the elementwise rtc kernels do too little arithmetic for it to
    bind."""
    return nbytes / PEAKS["H200" if "H200" in card else "H100"]["bytes"] \
        * 1e3


def resnet50_bn_relu_shapes(batch=32):
    """{(N, C, H, W): fragments} of the BatchNorm -> relu pairs of
    ResNet-50 v1 at 224x224 (mxnet_tpu/gluon/model_zoo/vision/resnet.py:
    58-75, the stride on the 3x3): the stem, then two per bottleneck."""
    shapes = {(batch, 64, 112, 112): 1}
    size = 56
    for stage, (blocks, ch) in enumerate(((3, 256), (4, 512), (6, 1024),
                                          (3, 2048))):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            mid = ch // 4
            first = (batch, mid, size, size)
            size //= stride
            second = (batch, mid, size, size)
            for s in (first, second):
                shapes[s] = shapes.get(s, 0) + 1
    return shapes


def phase_rtc_direct():
    """The direct rtc entry points as a user calls them: scale_add
    through the CudaModule/CudaKernel API on the JAX fixture (1, 8) and
    at 4096x4096, and relu as the kernel of a partitioned dense-relu
    MLP (b32, 1024 -> 4096 -> 1000). Counts are reset just before and
    read just after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc, rtc, subgraph
    from mxnet_tpu_torch.examples import rtc_kernels

    class DenseReLU(subgraph.SubgraphProperty):
        """The fixture of the JAX package's test_partition_pallas_backend:
        relu over FullyConnected, the matmul in torch, the relu the rtc
        kernel."""

        def select(self, node):
            return node._op == "Activation"

        def select_input(self, node, inp):
            return inp._op == "FullyConnected"

        def create_fn(self, sub_sym, arg_names):
            return lambda x, w, b: rtc_kernels.relu(
                torch.matmul(x, w.t()) + b)

    stats0 = dict(_nvrtc.STATS)
    t0 = time.perf_counter()
    rtc_kernels.module()
    compile_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    a = torch.arange(8, dtype=torch.float32, device="cuda").reshape(1, 8)
    b = torch.ones(1, 8, device="cuda")
    x = torch.randn(4096, 4096, generator=gen, device="cuda")
    y = torch.randn(4096, 4096, generator=gen, device="cuda")

    data = mx.sym.var("data")
    mlp = mx.sym.FullyConnected(data, num_hidden=4096, name="fc")
    mlp = mx.sym.Activation(mlp, act_type="relu", name="act")
    mlp = mx.sym.FullyConnected(mlp, num_hidden=1000, name="out")
    part = subgraph.partition(mlp, DenseReLU())
    rng = np.random.default_rng(SEED)
    shapes, _, _ = mlp.infer_shape(data=(32, 1024))
    args = {n: mx.nd.array(rng.standard_normal(s, dtype=np.float32)
                           * (0.03 if n != "data" else 1.0), ctx=mx.gpu(0))
            for n, s in zip(mlp.list_arguments(), shapes)}

    rtc_kernels.LAUNCHES.update(scale_add=0, relu=0)
    rtc.LAUNCHES = 0  # the main path starts here
    got_fixture = rtc_kernels.scale_add(a, b)
    got_big = rtc_kernels.scale_add(x, y)
    got_mlp = part.bind(mx.gpu(0), args, grad_req="null").forward()[0]
    torch.cuda.synchronize()
    launches = dict(rtc_kernels.LAUNCHES, rtc=rtc.LAUNCHES)  # just after
    check(launches == {"scale_add": 2, "relu": 1, "rtc": 3},
          "rtc direct path launches %s" % launches)
    want_mlp = mlp.bind(mx.gpu(0), args, grad_req="null").forward()[0]
    check(bool(torch.equal(got_fixture,
                           rtc_kernels.scale_add_reference(a, b))),
          "scale_add disagrees with its plain version at (1, 8)")
    check(bool(torch.equal(got_big, rtc_kernels.scale_add_reference(x, y))),
          "scale_add disagrees with its plain version at 4096x4096")
    # The fragment adds the bias after the product, FullyConnected inside
    # cuBLAS's epilogue: one rounding apart.
    mlp_err = _hold("the rtc relu MLP against the unpartitioned one",
                    got_mlp.data_, want_mlp.data_, 1e-5, 1e-6)
    pre = torch.matmul(args["data"].data_, args["fc_weight"].data_.t()) \
        + args["fc_bias"].data_
    check(bool(torch.equal(rtc_kernels.relu(pre),
                           rtc_kernels.relu_reference(pre))),
          "relu disagrees with its plain version")
    odd = _scale_add_at_an_odd_offset(gen)
    log(json.dumps({"phase": "rtc_direct", "launches": launches,
                    "scale_add_odd_offset": odd,
                    "mlp_max_abs_err_vs_unpartitioned": mlp_err,
                    "nvrtc_compile_s": compile_s,
                    "nvrtc_stats_delta": {k: _nvrtc.STATS[k] - stats0[k]
                                          for k in stats0},
                    "compile_log": rtc_kernels.module().compile_log}))
    return launches, (x, y, pre)


def _scale_add_at_an_odd_offset(gen, n=4096 * 33 + 3):
    """scale_add on contiguous views one element past a 16-byte boundary,
    at an odd n, through the public API: CudaModule/CudaKernel.launch on
    NDArrays with every pointer at that offset (a scalar head, float4
    vectors, a scalar tail), and the wrapper, whose aligned output makes
    the pointers differ mod 16 (the scalar path). Exact against the
    plain version."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import rtc_kernels
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    x, y, out = (torch.randn(n + 1, generator=gen, device="cuda")[1:]
                 for _ in range(3))
    want = rtc_kernels.scale_add_reference(x, y)
    with open(rtc_kernels.SOURCE) as f:
        kern = mx.rtc.CudaModule(f.read()).get_kernel(
            "scale_add", "const float *x, const float *y, float *out, "
            "int64_t n")
    plan = rtc_kernels.launch_plan(n, (x.data_ptr() % 16) // 4)
    kern.launch([NDArray(x), NDArray(y), NDArray(out), n], mx.gpu(0),
                (plan[3],), (256,))
    check(bool(torch.equal(out, want)), "scale_add through CudaKernel.launch"
          " disagrees with its plain version at offset 1, n %d" % n)
    check(bool(torch.equal(rtc_kernels.scale_add(x, y), want)),
          "scale_add disagrees with its plain version at offset 1, n %d" % n)
    return {"n": n, "offset_bytes": x.data_ptr() % 16,
            "plan": list(plan), "exact": True}


def _hold(name, got, want, rtol, atol_rel):
    atol = atol_rel * float(want.abs().max())
    err = float((got - want).abs().max())
    check(max_violation(got, want, rtol, atol) <= 0,
          "%s disagrees with its plain version: %g (rtol %g, atol %g)"
          % (name, err, rtol, atol))
    return err


def _elementwise_times(card, kernel, plain, library, nbytes):
    """An elementwise rtc kernel's times (ms) beside its plain version and
    the library call: device time (time_queued) and back-to-back calls
    (ms_host_window), with its bytes bound and the kernel's share."""
    row = {"ms": time_queued(kernel), "ms_host_window": time_each(kernel),
           "plain_ms": time_queued(plain),
           "bound_ms": _bytes_bound(card, nbytes),
           "library_ms": time_queued(library),
           "library_ms_host_window": time_each(library)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_bound_share"] = row["bound_ms"] / row["library_ms"]
    return row


def phase_rtc_kernels(card, tensors):
    """Each rtc kernel against its plain version and timed beside it,
    its bound and the library call: scale_add and relu exactly at the
    direct path's shapes; fused BatchNorm(inference)+ReLU at every
    distinct ResNet-50 v1 b32 shape within rtol 1e-5 + 1e-6 max|want|.
    Also the host cost of one CudaKernel.launch."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.examples import rtc_kernels
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    x, y, pre = tensors
    n0, r0, k0 = fb.LAUNCHES, dict(rtc_kernels.LAUNCHES), rtc.LAUNCHES
    entries = {}
    err = float((rtc_kernels.scale_add(x, y)
                 - rtc_kernels.scale_add_reference(x, y)).abs().max())
    check(err == 0, "scale_add not exact: %g" % err)
    entries["scale_add"] = {
        "name": "rtc_scale_add", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/elementwise.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": err,
        **_elementwise_times(card, lambda: rtc_kernels.scale_add(x, y),
                             lambda: rtc_kernels.scale_add_reference(x, y),
                             lambda: torch.add(y, x, alpha=2.0),
                             3 * 4 * x.numel()),
        "bound_by": "bytes",
        "library_call": "torch.add(y, x, alpha=2)",
        "shape": list(x.shape), "dtype": "float32"}
    err = float((rtc_kernels.relu(pre) - torch.relu(pre)).abs().max())
    check(err == 0, "relu not exact: %g" % err)
    # relu also where bytes, not the launch, set the time: over x.
    large_err = float((rtc_kernels.relu(x) - torch.relu(x)).abs().max())
    check(large_err == 0, "relu not exact at 4096x4096: %g" % large_err)
    entries["relu"] = {
        "name": "rtc_relu", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/elementwise.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": err,
        **_elementwise_times(card, lambda: rtc_kernels.relu(pre),
                             lambda: rtc_kernels.relu_reference(pre),
                             lambda: F.relu(pre), 2 * 4 * pre.numel()),
        "bound_by": "bytes",
        "library_call": "torch.nn.functional.relu",
        "shape": list(pre.shape), "dtype": "float32",
        "at_4096x4096": {
            "shape": list(x.shape), "max_abs_err": large_err,
            **_elementwise_times(card, lambda: rtc_kernels.relu(x),
                                 lambda: rtc_kernels.relu_reference(x),
                                 lambda: F.relu(x), 2 * 4 * x.numel())}}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    per_shape, bn_err, both_err = [], 0.0, None
    totals = {"ms": 0.0, "ms_host_window": 0.0, "plain_ms": 0.0,
              "bound_ms": 0.0, "library_ms": 0.0}
    for shape, count in resnet50_bn_relu_shapes(32).items():
        c = shape[1]
        xb = torch.randn(shape, generator=gen, device="cuda")
        g, be, m = (torch.rand(c, generator=gen, device="cuda") - 0.5
                    for _ in range(3))
        g, v = g + 1.0, torch.rand(c, generator=gen, device="cuda") + 0.5
        args = (xb, g, be, m, v, 1e-5, False, 1)
        got = fb.bn_relu(*args)
        want = fb.bn_relu_reference(*args)
        bn_err = max(bn_err, _hold("bn_relu %s" % (shape,), got, want, 1e-5,
                                   1e-6))
        row = {"shape": list(shape), "fragments": count,
               "ms": time_queued(lambda: fb.bn_relu(*args)),
               "ms_host_window": time_each(lambda: fb.bn_relu(*args)),
               "plain_ms": time_queued(lambda: fb.bn_relu_reference(*args)),
               "bound_ms": _bytes_bound(card, 2 * 4 * xb.numel()),
               "library_ms": time_queued(lambda: F.relu(F.batch_norm(
                   xb, m, v, g, be, training=False, eps=1e-5)))}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        per_shape.append(row)
        for k in totals:
            totals[k] += row[k] * count
        if shape == (32, 256, 28, 28):
            # The two-output variant, for a pair whose BatchNorm output
            # is read elsewhere too (not on ResNet-50's path): held, not
            # timed.
            both = zip(("z", "y"), fb.bn_and_relu(*args),
                       fb.bn_and_relu_reference(*args))
            both_err = max(_hold("bn_and_relu %s %s" % (k, shape), got_k,
                                 want_k, 1e-5, 1e-6)
                           for k, got_k, want_k in both)
            del both
        del xb, got, want
    stem = per_shape[0]
    entries["bn_relu"] = {
        "name": "rtc_bn_relu", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/fused_bn_relu.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": bn_err,
        "ms": stem["ms"], "plain_ms": stem["plain_ms"],
        "bound_ms": stem["bound_ms"], "bound_by": "bytes",
        "library_ms": stem["library_ms"],
        "library_call": "F.batch_norm(training=False) then F.relu",
        "shape": stem["shape"], "dtype": "float32",
        "per_shape": per_shape, "per_b32_forward": totals}

    # K4 itself: the runtime kernel surface, measured on its main path:
    # the 33 fused launches of one ResNet-50 b32 forward, summed; and the
    # host cost of one launch through CudaKernel.launch.
    kern = fb._get_kernel()
    tiny = [NDArray(torch.zeros(1, device="cuda")) for _ in range(6)]
    ctx = Context.of(tiny[0].data_.device)
    wrapper_x = torch.zeros(1, 1, 1, 1, device="cuda")
    one = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kern.launch(tiny + [1, 1, 1, 1e-5, 0], ctx, (1,), (32,))
    launch_us = (time.perf_counter() - t0) / 200 * 1e6
    t0 = time.perf_counter()
    for _ in range(200):
        fb.bn_relu(wrapper_x, one, one, one, one, 1e-5, False, 1)
    wrapper_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    entries["k4"] = {
        "name": "rtc.CudaModule (K4)", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:87",
        "max_abs_err": max(bn_err, entries["scale_add"]["max_abs_err"],
                           entries["relu"]["max_abs_err"]),
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "ms_host_window": totals["ms_host_window"],
        "what": "NVRTC-compiled kernels launched through CudaKernel.launch;"
                " times: the 33 BN+ReLU launches of one ResNet-50 v1 b32 "
                "forward, summed (device time, the card kept ahead of the "
                "host; ms_host_window: back-to-back calls, host-bound at "
                "the small shapes)",
        "host_us_per_launch": launch_us,
        "host_us_per_bn_relu_call": wrapper_us}
    # the comparisons above are not a main path: restore the counts
    fb.LAUNCHES, rtc.LAUNCHES = n0, k0
    rtc_kernels.LAUNCHES.update(r0)
    check(both_err is not None, "bn_and_relu was not held")
    log(json.dumps({"phase": "rtc_kernels", "bn_relu_per_shape": per_shape,
                    "bn_relu_per_b32_forward": totals,
                    "bn_and_relu_max_abs_err": both_err,
                    "host_us_per_launch": launch_us,
                    "host_us_per_bn_relu_call": wrapper_us}))
    return entries


def _randomize_bn(net, seed):
    """Non-trivial BatchNorm parameters and statistics, from numpy, so
    the fused kernel's arithmetic is exercised."""
    rng = np.random.default_rng(seed)
    for name, p in net.collect_params().items():
        if name.endswith(("running_var", "gamma")):
            p.set_data(rng.uniform(0.8, 1.2, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))


def phase_checkpoint_served():
    """ResNet-50 v1 exported and served from its checkpoint through
    InferenceServer.from_checkpoint, fp32 (TF32 off), buckets 1/8/32:
    once plain and once with MXNET_SUBGRAPH_BACKEND=fused_bn_relu. The
    fused kernel launches exactly 33 times per forward (warmup included)
    under the partition and never without it; both servers and the
    hybridized gluon net agree within 1e-5 of the largest logit; img/s
    at b32 on a batch on the card and through predict()."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc, autograd, nd, rtc, serving
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.gluon.model_zoo import vision

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    item, buckets = (3, 224, 224), (1, 8, 32)
    compiles0 = _nvrtc.STATS["compiles"]
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    rng = np.random.default_rng(SEED + 5)
    probe = rng.random((5,) + item, dtype=np.float32)
    with torch.no_grad(), autograd.pause():
        net(nd.array(probe[:1], ctx=mx.gpu(0)))
    _randomize_bn(net, SEED + 6)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    result = {"phase": "resnet50_v1_checkpoint_served", "buckets": buckets}
    servers = {}
    try:
        t0 = time.perf_counter()
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix)
        result["export_s"] = time.perf_counter() - t0
        with torch.no_grad(), autograd.pause():
            want = net(nd.array(probe, ctx=mx.gpu(0))).data_
        rows = [1, 5, 32]
        reqs = [probe[:1], probe, rng.random((32,) + item, dtype=np.float32)]
        for tag in ("plain", "partitioned"):
            if tag == "partitioned":
                os.environ["MXNET_SUBGRAPH_BACKEND"] = fb.BACKEND
            fb.LAUNCHES = rtc.LAUNCHES = 0  # the main path starts here
            t0 = time.perf_counter()
            try:
                srv = serving.InferenceServer.from_checkpoint(
                    prefix, 0, item_shape=item, buckets=buckets,
                    max_delay_ms=5, ctx=mx.gpu(0))
            finally:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            servers[tag] = srv
            warm_s = time.perf_counter() - t0
            with ThreadPoolExecutor(len(reqs)) as pool:
                futs = list(pool.map(srv.submit, reqs))
            outs = [f.result(timeout=300) for f in futs]
            launches = (fb.LAUNCHES, rtc.LAUNCHES)  # read just after
            exs = srv._model._executors
            forwards = sum(ex.num_forwards for ex in exs.values())
            frags = {b[0]: sum(1 for n in ex._symbol._topo()
                               if n._op == "_subgraph")
                     for b, ex in exs.items()}
            check(srv.compile_count == len(buckets),
                  "%s: compile_count %d" % (tag, srv.compile_count))
            for r, o in zip(rows, outs):
                check(o.shape == (r, 1000), "served shape %s" % (o.shape,))
                check(bool(torch.isfinite(o.data_).all()),
                      "non-finite %s output" % tag)
            per_fwd = 33 if tag == "partitioned" else 0
            check(all(f == per_fwd for f in frags.values()),
                  "%s: fragments per bucket %s" % (tag, frags))
            check(launches == (per_fwd * forwards, per_fwd * forwards),
                  "%s: bn_relu/rtc launches %s for %d forwards"
                  % (tag, launches, forwards))
            result[tag] = {"warmup_s": warm_s, "forwards": forwards,
                           "batches": srv.metrics.total_batches,
                           "fragments_per_bucket": frags,
                           "bn_relu_launches": launches[0],
                           "rtc_launches": launches[1],
                           "probe": outs[1].data_}
        scale = float(want.abs().max())
        errs = {}
        for tag in servers:
            got = result[tag].pop("probe")
            errs[tag + "_vs_gluon"] = float((got - want).abs().max())
        errs["partitioned_vs_plain"] = float(
            (servers["partitioned"].predict(probe).data_
             - servers["plain"].predict(probe).data_).abs().max())
        result["agreement"] = {"max_abs_logit": scale, "limit": 1e-5 * scale,
                               **errs}
        for k, e in errs.items():
            check(e <= 1e-5 * scale, "%s: %g > 1e-5 x %g" % (k, e, scale))

        batch = nd.array(rng.random((32,) + item, dtype=np.float32),
                         ctx=mx.gpu(0))
        host32 = rng.random((32,) + item, dtype=np.float32)

        def gluon_forward():
            with torch.no_grad(), autograd.pause():
                net(batch).wait_to_read()

        result["gluon_hybridized"] = {"forward_ms_b32":
                                      time_ms(gluon_forward)}
        for tag, srv in servers.items():
            n0 = fb.LAUNCHES
            ms = time_ms(lambda: srv._model(batch).wait_to_read())
            t0 = time.perf_counter()
            for _ in range(ITERS):
                srv.predict(host32).wait_to_read()
            served = (time.perf_counter() - t0) / ITERS
            result[tag].update({"forward_ms_b32": ms,
                                "forward_img_s_b32": 32e3 / ms,
                                "served_ms_b32": served * 1e3,
                                "served_img_s_b32": 32 / served,
                                "stats": srv.stats()})
            fb.LAUNCHES = n0  # timing runs are not the main path
    finally:
        for srv in servers.values():
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    # 3 buckets x 33 fragments share one compiled program
    result["nvrtc_stats"] = dict(_nvrtc.STATS)
    compiled = _nvrtc.STATS["compiles"] - compiles0
    check(compiled <= 1, "NVRTC compiled %d programs in the checkpoint "
          "phase, not at most one" % compiled)
    log(json.dumps(result))
    return result


# -- slice 7: the imperative trainer (gluon.Trainer) ---------------------------

TRAINER_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RESNET50_TRAINABLE = 161


def _resnet50(seed=SEED, dtype=None):
    """ResNet-50 v1 at full width on the card, initialized as the
    TrainStep phases initialize it, shapes inferred, hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    with autograd.pause():
        net(nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
    if dtype is not None:
        net.cast(dtype)
    net.hybridize()
    return net


def _copy_weights(src, dst):
    for p, q in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        q.data()._data.detach().copy_(p.data()._data.detach())


def _trainable(net):
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def _record_and_backward(net, x, y, cast_out=False, loss_fn=None):
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = loss_fn or gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        out = net(x)
        if cast_out:
            out = out.astype("float32")
        loss = loss_fn(out, y)
    loss.backward()
    return loss


def _state_tensors(trainer):
    """{index: [state tensors]} of a trainer's updater, nesting
    flattened ((inner, master) under multi_precision)."""
    def flat(s):
        if s is None:
            return []
        if isinstance(s, (list, tuple)):
            return [t for x in s for t in flat(x)]
        return [s._data]

    return {i: flat(s) for i, s in trainer._updater.states.items()}


def _trainer_img_s(net, trainer, x, y, cast_out, warmup=3, windows=5,
                   iters=16):
    """benchmark_rate's protocol over the Trainer loop: warmup steps,
    then the median img/s of `windows` windows of `iters` steps, each
    closed by a host readback of the loss."""
    loss = None
    for _ in range(warmup):
        loss = _record_and_backward(net, x, y, cast_out)
        trainer.step(x.shape[0])
    float(loss.asnumpy().mean())
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = _record_and_backward(net, x, y, cast_out)
            trainer.step(x.shape[0])
        float(loss.asnumpy().mean())
        rates.append(x.shape[0] * iters / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2], float(loss.asnumpy().mean())


def _optimizer_profile(trainer, batch, reps=5):
    """Per trainer.step on the gradients in place: CUDA launches and
    device ms (torch.profiler), and host ms (the card synchronised at
    the end of the window)."""
    trainer.step(batch)       # plans and states exist
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            trainer.step(batch)
        torch.cuda.synchronize()
    count, device_us = 0, 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            count += evt.count
            device_us += evt.self_device_time_total
    return {"launches_per_step": count / reps,
            "device_ms_per_step": device_us / 1e3 / reps,
            "wall_ms_per_step": wall}


def _fused_equals_loop(dtype, x, y, steps=2):
    """From one state and on the same gradients, `steps` fused steps and
    `steps` loop steps: every weight and optimizer-state tensor equal bit
    for bit. Returns the number of trainable tensors held."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    opt = dict(TRAINER_OPT, multi_precision=dtype is not None)
    nets = [_resnet50(dtype=dtype) for _ in range(2)]
    _copy_weights(nets[0], nets[1])
    trainers = [gluon.Trainer(n.collect_params(), "sgd", dict(opt), fused=f)
                for n, f in zip(nets, (True, False))]
    train = [_trainable(n) for n in nets]
    check(len(train[0]) == RESNET50_TRAINABLE, "ResNet-50 v1 has %d "
          "trainable tensors, not %d" % (len(train[0]), RESNET50_TRAINABLE))
    for _ in range(steps):
        _record_and_backward(nets[0], x, y, dtype is not None)
        for p, q in zip(*train):
            q.grad()._data.copy_(p.grad()._data)
        for t in trainers:
            t.step(x.shape[0])
    bad = [p.name for p, q in zip(*train)
           if not torch.equal(p.data()._data, q.data()._data)]
    sa, sb = (_state_tensors(t) for t in trainers)
    bad += ["state %d" % i for i in sa
            if len(sa[i]) != len(sb[i]) or
            not all(torch.equal(u, v) for u, v in zip(sa[i], sb[i]))]
    check(not bad, "fused != loop (%s) at %s" % (dtype or "fp32", bad[:5]))
    check(trainers[0]._applier.num_compiles >= 1
          and trainers[1]._applier.num_compiles == 0,
          "the fused trainer did not fuse, or the loop trainer did")
    masters = [s for i, s in trainers[0]._updater.states.items()]
    if dtype is not None:
        check(all(isinstance(s, tuple) and len(s) == 2
                  and s[1]._data.dtype == torch.float32 for s in masters),
              "bf16 states are not (inner, fp32 master)")
    del nets, trainers
    return len(train[0])


def _resume_equals_uninterrupted(x, y, tmpdir):
    """4 uninterrupted fused steps against 2 steps, save_states,
    load_states into a fresh Trainer, 2 more steps, on the same recorded
    gradients: weights and states equal bit for bit."""
    import os

    from mxnet_tpu_torch import gluon

    nets = [_resnet50() for _ in range(2)]
    _copy_weights(nets[0], nets[1])
    train = [_trainable(n) for n in nets]
    ref = gluon.Trainer(nets[0].collect_params(), "sgd", dict(TRAINER_OPT))
    grads = []
    for _ in range(4):
        _record_and_backward(nets[0], x, y)
        grads.append([p.grad()._data.clone() for p in train[0]])
        ref.step(x.shape[0])
    path = os.path.join(tmpdir, "trainer.states")
    tr = gluon.Trainer(nets[1].collect_params(), "sgd", dict(TRAINER_OPT))
    for k, gs in enumerate(grads):
        if k == 2:
            tr.save_states(path)
            tr = gluon.Trainer(nets[1].collect_params(), "sgd",
                               dict(TRAINER_OPT))
            tr.load_states(path)
        for q, g in zip(train[1], gs):
            q.grad()._data.copy_(g)
        tr.step(x.shape[0])
    bad = [p.name for p, q in zip(*train)
           if not torch.equal(p.data()._data, q.data()._data)]
    sa, sb = _state_tensors(ref), _state_tensors(tr)
    bad += ["state %d" % i for i in sa
            if not all(torch.equal(u, v) for u, v in zip(sa[i], sb[i]))]
    check(not bad, "resumed Trainer != uninterrupted at %s" % bad[:5])
    return os.path.getsize(path)


def _update_bytes(net, dtype):
    """Bytes one SGD-momentum update must move: read weight, gradient
    and momentum, write weight and momentum; with fp32 masters also
    read and write the master, the momentum fp32."""
    n = sum(p.data().size for p in _trainable(net))
    if dtype is None:
        return 5 * 4 * n
    return (2 + 2 + 4 + 4) * n + (2 + 4 + 4) * n


def phase_resnet_trainer(card_line):
    """ResNet-50 v1 through gluon.Trainer (see the module docstring,
    phase 11)."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    rng = np.random.default_rng(SEED)
    xs = rng.random((32, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, 32).astype(np.float32)
    y = nd.array(ys, ctx=mx.gpu(0))
    result = {"phase": "resnet50_v1_trainer", "card": card_line,
              "batch": 32, "optimizer": ["sgd", TRAINER_OPT],
              "windows": 5, "iters_per_window": 16}
    _reset_launches()  # the main path starts here
    card = torch.cuda.get_device_name(0)
    for tag, dtype in (("fp32", None), ("bf16_mp", "bfloat16")):
        x = nd.array(xs, ctx=mx.gpu(0), dtype=dtype or "float32")
        net = _resnet50(dtype=dtype)
        opt = dict(TRAINER_OPT, multi_precision=dtype is not None)
        trainer = gluon.Trainer(net.collect_params(), "sgd", opt)
        t0 = time.perf_counter()
        rate, loss = _trainer_img_s(net, trainer, x, y, dtype is not None)
        entry = {"img_s_b32": rate, "ms_per_step": 32e3 / rate,
                 "loss": loss, "phase_s": time.perf_counter() - t0,
                 "fused_plans": trainer._applier.num_compiles}
        check(np.isfinite(loss), "non-finite Trainer loss %r" % loss)
        check(trainer._applier.num_compiles >= 1, "the Trainer did not "
              "take the fused path")
        # The optimizer alone, on the gradients of the last step.
        fused = _optimizer_profile(trainer, 32)
        loop = gluon.Trainer(net.collect_params(), "sgd", opt, fused=False)
        _record_and_backward(net, x, y, dtype is not None)
        per_param = _optimizer_profile(loop, 32)
        for key in ("launches_per_step", "device_ms_per_step",
                    "wall_ms_per_step"):
            entry["optimizer_" + key] = {"fused": fused[key],
                                         "loop": per_param[key]}
        nbytes = _update_bytes(net, dtype)
        entry["optimizer_bytes"] = nbytes
        entry["optimizer_bound_ms"] = _bytes_bound(card, nbytes)
        entry["optimizer_bound_share_fused"] = \
            entry["optimizer_bound_ms"] / fused["device_ms_per_step"]
        result[tag] = entry
        del net, trainer, loop
        torch.cuda.empty_cache()
    launches = _launches()  # read just after the path
    result["flash_attention_launches"] = launches
    check(launches == (0, 0, 0), "ResNet-50 Trainer launched flash "
          "attention kernels %s" % (launches,))

    x = nd.array(xs, ctx=mx.gpu(0))
    result["fused_equals_loop_fp32_tensors"] = _fused_equals_loop(None, x, y)
    torch.cuda.empty_cache()
    xb = nd.array(xs, ctx=mx.gpu(0), dtype="bfloat16")
    result["fused_equals_loop_bf16_mp_tensors"] = _fused_equals_loop(
        "bfloat16", xb, y)
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trainer-", dir=build)
    try:
        result["resume_states_bytes"] = _resume_equals_uninterrupted(
            x, y, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["resume_equals_uninterrupted"] = True
    torch.cuda.empty_cache()
    log(json.dumps(result))
    return result


def phase_attention_trainer(card_line):
    """The attention layer through gluon.Trainer: adam, bf16 weights with
    fp32 masters, 10 steps on one batch (module docstring, phase 12)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention

    units, steps = 1024, 10
    mx.random.seed(SEED)
    net = SelfAttention(units, heads=16)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3, "multi_precision": True})
    rng = np.random.default_rng(SEED)
    x = nd.array(rng.standard_normal((8, 2048, units), dtype=np.float32),
                 ctx=mx.gpu(0), dtype="bfloat16")
    y = nd.array(rng.standard_normal((8, 2048, units), dtype=np.float32),
                 ctx=mx.gpu(0))
    loss_fn = gluon.loss.L2Loss()
    losses, per_step, times = [], [], []
    _reset_launches()  # the main path starts here
    for _ in range(steps):
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _record_and_backward(net, x, y, True, loss_fn)
        trainer.step(8)
        losses.append(float(loss.asnumpy().mean()))
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_launches(), before)))
    launches = _launches()  # read just after the path
    check(all(c == (1, 1, 1) for c in per_step),
          "Trainer: K1/K2/K3 launches per step %s, not once each" % per_step)
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)
    check(trainer._applier.num_compiles >= 1, "adam did not take the "
          "fused path")
    masters = list(trainer._updater.states.values())
    check(all(s[1]._data.dtype == torch.float32 for s in masters),
          "adam states are not (inner, fp32 master)")
    result = {"phase": "attention_layer_trainer", "card": card_line,
              "shape": [8, 16, 2048, 64], "dtype": "bfloat16",
              "optimizer": ["adam", {"learning_rate": 1e-3,
                                     "multi_precision": True}],
              "steps": steps, "losses": losses, "step_ms": times,
              "step_ms_median": float(np.median(times[2:])),
              "launches_per_step": per_step, "launches": launches}
    log(json.dumps(result))
    return launches, result["step_ms_median"]


# Phase 13: the input pipeline. Records, widths and protocol.
PIPE_RECORDS = 512
PIPE_SIDE = 256
PIPE_BATCH = 32
PIPE_SHAPE = (3, 224, 224)
PIPE_MEAN = (123.68, 116.28, 103.53)
PIPE_STD = (58.395, 57.12, 57.375)
# PCIe transfer rate per lane (GT/s) and line-code efficiency by gen.
PCIE_GT_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}


def _all_launches():
    """Every launch counter of the port's kernels: K1-K3, K4 (rtc), the
    fused BN+ReLU and the elementwise rtc kernels."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

    return {"k1_k2_k3": _launches(), "rtc": rtc.LAUNCHES,
            "bn_relu": fused_bn_relu.LAUNCHES,
            "scale_add": rtc_kernels.LAUNCHES["scale_add"],
            "relu": rtc_kernels.LAUNCHES["relu"]}


def _reset_all_launches():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

    _reset_launches()
    rtc.LAUNCHES = 0
    fused_bn_relu.LAUNCHES = 0
    rtc_kernels.LAUNCHES["scale_add"] = rtc_kernels.LAUNCHES["relu"] = 0


def _write_records(tmpdir, n=PIPE_RECORDS, side=PIPE_SIDE, seed=SEED):
    """n PNG records of side x side x 3 noise, labels in [0, 1000), and
    their .idx, written with the port's recordio."""
    import os

    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    rec = os.path.join(tmpdir, "train.rec")
    idx = os.path.join(tmpdir, "train.idx")
    writer = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, (side, side, 3), dtype=np.uint8)
        header = recordio.IRHeader(0, float(rng.randint(0, 1000)), i, 0)
        writer.write_idx(i, recordio.pack_img(header, img, img_fmt=".png"))
    writer.close()
    return rec, idx


def _pipeline(rec, ctx, place, seed=SEED, threads=4, random_aug=False):
    from mxnet_tpu_torch import data

    decoder = data.ImageRecordDecoder(
        PIPE_SHAPE, rand_crop=random_aug, rand_mirror=random_aug,
        mean=np.array(PIPE_MEAN), std=np.array(PIPE_STD), seed=seed)
    return data.DataPipeline(rec, decoder, PIPE_BATCH, shuffle=True,
                             seed=seed, decode_threads=threads, prefetch=2,
                             place=place, ctx=ctx)


def _record_iter(rec, idx, ctx, seed=SEED):
    import mxnet_tpu_torch as mx

    return mx.io.ImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=PIPE_SHAPE,
        batch_size=PIPE_BATCH, shuffle=True, preprocess_threads=4,
        mean_r=PIPE_MEAN[0], mean_g=PIPE_MEAN[1], mean_b=PIPE_MEAN[2],
        std_r=PIPE_STD[0], std_g=PIPE_STD[1], std_b=PIPE_STD[2], ctx=ctx,
        seed=seed)


def _card_equals_host(card_batches, host_batches, step, what):
    """Each batch delivered on the card, read back before and after a
    fp32 train step on it, equals the host pass's batch bit for bit."""
    bad = 0
    n = 0
    for got, want in zip(card_batches, host_batches):
        x, y = got.data[0], got.label[0]
        check(x.context.device_type == "gpu", "%s delivered on %s"
              % (what, x.context))
        before = torch.empty(x.shape, dtype=x.data_.dtype, pin_memory=True)
        before.copy_(x.data_, non_blocking=True)   # ordered after the copy
        step(x, y)
        after = x.data_.cpu()                       # after the step read it
        want_x = np.asarray(want.data[0])
        want_y = np.asarray(want.label[0])
        for arr in (before.numpy(), after.numpy()):
            bad += int(not np.array_equal(arr.view(np.uint32),
                                          want_x.view(np.uint32)))
        bad += int(not np.array_equal(y.asnumpy(), want_y))
        n += 1
    return n, bad


def _fed_rate(step, batches, warmup=3, windows=3, iters=16):
    """benchmark_rate's protocol over batches from a data source: warmup
    steps, then the median img/s of windows of `iters` steps, each
    closed by a host readback of the loss; and the data-wait share of
    the windows (time blocked in next() over wall time) beside
    ``stall_fraction`` of the spans recorded in them."""
    from mxnet_tpu_torch.data import stall_fraction
    from mxnet_tpu_torch.telemetry import trace

    it = iter(batches)

    def pull():
        b = next(it)
        return (b.data[0], b.label[0]) if hasattr(b, "data") else b

    loss = None
    for _ in range(warmup):
        loss = step(*pull())
    float(loss)
    trace.clear()
    rates, waited, wall = [], 0.0, 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            t1 = time.perf_counter()
            x, y = pull()
            waited += time.perf_counter() - t1
            loss = step(x, y)
        float(loss)
        dt = time.perf_counter() - t0
        wall += dt
        rates.append(PIPE_BATCH * iters / dt)
    return {"img_s": sorted(rates)[len(rates) // 2],
            "data_wait_share": waited / wall,
            "stall_fraction": stall_fraction(),
            "loss": float(loss)}


class _DecodeSample:
    """DataLoader worker body: one PNG record to (CHW float32, label)
    through `augs` (host numpy only)."""

    def __init__(self, augs):
        self.augs = augs

    def __call__(self, record):
        from mxnet_tpu_torch import recordio
        from mxnet_tpu_torch.image import image as img_mod

        header, payload = recordio.unpack(record)
        img = img_mod._imdecode_np(payload)      # RGB, as the iterators
        for aug in self.augs:
            img = aug(img)
        return (np.ascontiguousarray(np.asarray(img, np.float32)
                                     .transpose(2, 0, 1)),
                np.float32(header.label))


def _loader_batches(rec, workers, epochs=100):
    """Batches of a process-pool DataLoader over the raw records, each
    decoded (random crop and mirror, normalized) in a worker, pinned and
    copied to gpu(0)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.image import image as img_mod

    augs = img_mod.CreateAugmenter(
        PIPE_SHAPE, rand_crop=True, rand_mirror=True,
        mean=np.array(PIPE_MEAN), std=np.array(PIPE_STD))
    ds = gluon.data.RecordFileDataset(rec).transform(_DecodeSample(augs))
    loader = gluon.data.DataLoader(ds, PIPE_BATCH, shuffle=True,
                                   last_batch="discard",
                                   num_workers=workers, pin_memory=True)

    def gen():
        for _ in range(epochs):
            for x, y in loader:
                yield x, y
    return loader, gen()


def _upload_times():
    """One 19.27 MB batch (32x3x224x224 fp32) host to card: pinned
    against pageable, CUDA-event median of 10, beside the link's bound."""
    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        PIPE_BATCH, *PIPE_SHAPE).astype(np.float32))
    pinned = x.pin_memory()
    dev = torch.empty(x.shape, device="cuda")
    nbytes = x.numel() * 4
    out = {"bytes": nbytes}
    for tag, src in (("pageable_ms", x), ("pinned_ms", pinned),
                     ("pinned_ms_2", pinned), ("pageable_ms_2", x)):
        out[tag] = time_ms(lambda: dev.copy_(src, non_blocking=True),
                           iters=10)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["nvidia_smi_pcie"] = smi
    fields = [v.strip() for v in smi.split(",")]
    links = [(fields[0], fields[1], "nvidia-smi current"),
             (fields[2], fields[3], "nvidia-smi max"),
             # Where the card reports neither: the H100 SXM5 data sheet.
             ("5", "16", "data sheet (nvidia-smi reads N/A)")]
    gen, width, source = next((int(g), int(w), src) for g, w, src in links
                              if g.isdigit() and w.isdigit())
    rate = PCIE_GT_S[gen] * 1e9 * width * (128 / 130 if gen >= 3 else 0.8) / 8
    out["link"] = "PCIe gen%d x%d (%s)" % (gen, width, source)
    out["link_bound_ms"] = nbytes / rate * 1e3
    out["pinned_share_of_bound"] = out["link_bound_ms"] / min(
        out["pinned_ms"], out["pinned_ms_2"])
    return out


def phase_input_pipeline(card_line, synthetic):
    """ResNet-50 v1 at full width trained from a .rec: 512 PNG records
    of 256x256x3 noise written with the port's recordio; DataPipeline
    (4 decode threads, prefetch 2, place=True: pinned staging and a
    side-stream copy to gpu(0)) and ImageRecordIter, each batch on the
    card held bit for bit against the same source's host pass while a
    b32 fp32 TrainStep runs on it; the pipeline's img/s at 1, 4 and 8
    decode threads; one batch's upload pinned against pageable beside
    the link's bound; ResNet-50 train img/s fed by the pipeline (fp32,
    bf16) and, bf16, by a process-pool DataLoader, beside phase 7's
    synthetic img/s, with the data-wait share of each; the gluon loop
    (DataLoader, pin_memory, gluon.Trainer) at its own configuration.
    The native RecordIO reader must be the one that ran."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recordio_native
    from mxnet_tpu_torch.examples import gluon_image_classification as gic
    from mxnet_tpu_torch.examples import train_imagenet

    check(recordio_native.available(), "the native RecordIO reader did "
          "not build on this host")
    result = {"phase": "input_pipeline", "card": card_line,
              "records": PIPE_RECORDS, "record_shape": [PIPE_SIDE,
                                                         PIPE_SIDE, 3],
              "batch": PIPE_BATCH}
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        t0 = time.perf_counter()
        rec, idx = _write_records(tmpdir)
        result["write_s"] = time.perf_counter() - t0
        log("phase 13: wrote %d records in %.1f s"
            % (PIPE_RECORDS, result["write_s"]))
        result["rec_mb"] = __import__("os").path.getsize(rec) / 1e6
        _reset_all_launches()   # the main path starts here
        reads0 = recordio_native.READS
        gpu, host = mx.gpu(0), mx.cpu()
        mx.random.seed(SEED)
        step = train_imagenet.build_train_step("resnet50", device=gpu)
        # Gate: the card's copy equals the host bytes, under a step.
        t0 = time.perf_counter()
        with _pipeline(rec, host, place=False) as pipe:
            want = [next(pipe) for _ in range(PIPE_RECORDS // PIPE_BATCH)]
        with _pipeline(rec, gpu, place=True) as pipe:
            got = (next(pipe) for _ in range(len(want)))
            n, bad = _card_equals_host(got, want, step, "DataPipeline")
        check(n == len(want) and bad == 0, "DataPipeline: %d of %d batches "
              "on the card differ from the host pass" % (bad, n))
        it_host = _record_iter(rec, idx, host)
        want = [b for b in it_host]
        it_host.close()
        it_card = _record_iter(rec, idx, gpu)
        n, bad = _card_equals_host(it_card, want, step, "ImageRecordIter")
        it_card.close()
        check(n == len(want) == PIPE_RECORDS // PIPE_BATCH and bad == 0,
              "ImageRecordIter: %d of %d batches on the card differ from "
              "the host pass" % (bad, n))
        log("phase 13: gate passed, %.1f s" % (time.perf_counter() - t0))
        result["gate"] = {"datapipeline_batches": len(want),
                          "imagerecorditer_batches": n, "mismatches": 0,
                          "seconds": time.perf_counter() - t0}
        # The pipeline alone, rand crop + mirror, copy included.
        result["pipeline_img_s"] = {}
        for threads in (1, 4, 8):
            with _pipeline(rec, gpu, True, threads=threads,
                           random_aug=True) as pipe:
                next(pipe)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PIPE_RECORDS // PIPE_BATCH):
                    batch = next(pipe)
                batch.data[0].wait_to_read()
                result["pipeline_img_s"][threads] = \
                    PIPE_RECORDS / (time.perf_counter() - t0)
        log("phase 13: pipeline alone", result["pipeline_img_s"])
        result["upload"] = _upload_times()
        # ResNet-50 fed by the pipeline (threads) and a DataLoader
        # (processes), beside phase 7's synthetic rates.
        fed = {}
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            mx.random.seed(SEED)
            s = train_imagenet.build_train_step("resnet50", dtype=dtype,
                                                device=gpu)
            with _pipeline(rec, gpu, True, random_aug=True) as pipe:
                fed[tag] = _fed_rate(s, pipe)
            fed[tag]["synthetic_img_s"] = synthetic[tag]["img_s_b32"]
            log("phase 13: fed", tag, fed[tag])
        mx.random.seed(SEED)
        s = train_imagenet.build_train_step("resnet50", dtype="bfloat16",
                                            device=gpu)
        loader, batches = _loader_batches(rec, workers=4)
        try:
            fed["bf16_dataloader_4_workers"] = _fed_rate(s, batches)
        finally:
            loader.close()
        # The DataLoader records no data::wait spans: its wait is the
        # share measured around next().
        del fed["bf16_dataloader_4_workers"]["stall_fraction"]
        fed["bf16_dataloader_4_workers"]["synthetic_img_s"] = \
            synthetic["bf16"]["img_s_b32"]
        log("phase 13: fed by the DataLoader",
            fed["bf16_dataloader_4_workers"])
        result["train_fed"] = fed
        result["native_reads"] = recordio_native.READS - reads0
        check(result["native_reads"] >= 2 * PIPE_RECORDS, "the pipeline "
              "read %d records through the native reader"
              % result["native_reads"])
        # The gluon loop at its own configuration, with cuDNN's
        # deterministic algorithms: its loss check reads the mean loss of
        # five epochs of a seeded run, which nondeterministic
        # convolutions made differ from run to run (near zero, a spike
        # in the last epoch read above the first in one run of three).
        result["gluon_loop"] = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for workers in (0, 4):
                t0 = time.perf_counter()
                run = gic.run(num_workers=workers, pin_memory=True, ctx=gpu)
                run["seconds"] = time.perf_counter() - t0
                losses = [e["loss"] for e in run["epochs"]]
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      "the gluon loop's loss did not fall (workers %d): %s"
                      % (workers, losses))
                result["gluon_loop"][workers] = run
                log("phase 13: gluon loop, %d workers, %.1f s, losses %s"
                    % (workers, run["seconds"], losses))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    check(launches["k1_k2_k3"] == (0, 0, 0) and launches["rtc"] == 0,
          "the input pipeline launched kernels %s" % (launches,))
    log(json.dumps(result))
    return result


# -- slice 9: checkpoint and the Module API ----------------------------------

CKPT_KEEP_LAST = 2
CKPT_STEPS = 4          # bit-exact resume: save every step, restore step 2
CKPT_RESTORE = 2
SIGTERM_AT_PARAM = 80   # phase 14's in-step SIGTERM: the k-th parameter


def _state_bytes(tree):
    """Bytes of the arrays and bytes leaves of a nested state."""
    n = 0
    for v in tree.values():
        if isinstance(v, dict):
            n += _state_bytes(v)
        elif isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif isinstance(v, (bytes, bytearray)):
            n += len(v)
    return n


def _fs_info(path):
    import shutil

    usage = shutil.disk_usage(path)
    fstype = subprocess.run(["stat", "-f", "-c", "%T", path],
                            capture_output=True, text=True,
                            timeout=60).stdout.strip()
    return {"dir": path, "free_gb": usage.free / 1e9,
            "total_gb": usage.total / 1e9, "fs_type": fstype}


def _spans_ms(events, name):
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("name") == name]


def _stats(values):
    if not values:
        return None
    v = sorted(values)
    return {"n": len(v), "median": v[len(v) // 2], "mean": sum(v) / len(v),
            "min": v[0], "max": v[-1]}


def _ckpt_rate(step, x, y, tmpdir, every, warmup=3, windows=5, iters=16):
    """benchmark_rate's protocol (warmup steps, then the median img/s of
    `windows` windows of `iters` steps, each closed by a host readback of
    the loss) with an async ``CheckpointManager.save`` of the step's
    state every `every` steps (0: none), keep_last=2; then the writer's
    figures, read from its trace spans and totals after it drained."""
    import os
    import shutil

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.telemetry import trace

    d = os.path.join(tmpdir, "every-%d-%d" % (every, step.num_update))
    mgr = CheckpointManager(d, keep_last=CKPT_KEEP_LAST)
    loss = None
    for _ in range(warmup):
        loss = step(x, y)
    float(loss)
    trace.clear()
    rates, save_ms, state_ms = [], [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step(x, y)
            if every and step.num_update % every == 0:
                t1 = time.perf_counter()
                state = step.state_dict()
                t2 = time.perf_counter()
                mgr.save(step.num_update, state)
                del state
                state_ms.append((t2 - t1) * 1e3)
                save_ms.append((time.perf_counter() - t2) * 1e3)
        float(loss)
        rates.append(x.shape[0] * iters / (time.perf_counter() - t0))
    t_wait = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t_wait
    events = trace.chrome_trace()["traceEvents"]
    out = {"every": every, "img_s_b32": sorted(rates)[len(rates) // 2],
           "img_s_windows": rates, "loss": float(loss)}
    if every:
        commits = mgr.all_steps()
        out.update({
            "saves_requested": len(save_ms),
            "dropped_saves": mgr.dropped_saves,
            "state_dict_ms": _stats(state_ms),
            "save_call_ms": _stats(save_ms),
            "snapshot_span_ms": _stats(_spans_ms(events,
                                                 "checkpoint::snapshot")),
            "write_span_ms": _stats(_spans_ms(events, "checkpoint::write")),
            "commit_span_ms": _stats(_spans_ms(events,
                                               "checkpoint::commit")),
            "writer_bytes": mgr.total_bytes,
            "writer_seconds": mgr.total_save_seconds,
            "writer_mb_s": mgr.total_bytes / 1e6
            / max(mgr.total_save_seconds, 1e-9),
            "drain_after_windows_s": wait_s,
            "committed_steps": commits,
            "last_error": repr(mgr.last_error)})
        check(mgr.last_error is None, "checkpoint writer failed: %r"
              % (mgr.last_error,))
        check(commits and commits[-1] == step.num_update,
              "the newest save (step %d) did not commit: %s"
              % (step.num_update, commits))
    mgr.close()
    shutil.rmtree(d, ignore_errors=True)
    return out


def _pageable_copy_ms(state, reps=3):
    """The state's tensors copied to pageable host memory, one .cpu()
    each (what a snapshot without pinned staging costs)."""
    flat = []

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                flat.append(v)
    walk(state)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [v.cpu() for v in flat]
        times.append((time.perf_counter() - t0) * 1e3)
        del host
    return sorted(times)[len(times) // 2]


def _equal_trees(a, b, where=""):
    """Names of the leaves that differ bit for bit between two states."""
    bad = []
    for k in set(a) | set(b):
        u, v = a.get(k), b.get(k)
        name = where + k
        if isinstance(u, dict) and isinstance(v, dict):
            bad += _equal_trees(u, v, name + "/")
        elif isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
            if u.dtype != v.dtype or u.shape != v.shape or \
                    not torch.equal(u.cpu(), v.cpu()):
                bad.append(name)
        elif u != v:
            bad.append(name)
    return bad


def _resnet_batches(n, batch=32, seed=SEED, dtype=None):
    """`n` synthetic ImageNet batches on gpu(0): images uniform in [0, 1),
    labels in [0, 1000)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((batch, 3, 224, 224), dtype=np.float32)
        y = rng.integers(0, 1000, batch).astype(np.float32)
        out.append((nd.array(x, ctx=mx.gpu(0), dtype=dtype or "float32"),
                    nd.array(y, ctx=mx.gpu(0))))
    return out


def _fresh_names():
    """Restart gluon's per-class block counters, as a new process starts
    them: a net built next gets the parameter names the first net of a
    process gets (names are counter based, ROADMAP Queue 3), which a
    TrainStep state is keyed by."""
    from mxnet_tpu_torch.gluon.block import _BlockScope

    _BlockScope._counters.clear()


def _trainstep_resume(tmpdir, batches):
    """4 TrainStep steps saving each, step 2 restored into a fresh step
    (other random weights) and 2 more steps, against 4 uninterrupted
    steps, bit for bit; and the uninterrupted run repeated (a control of
    the card's determinism)."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.examples import train_imagenet

    def build(seed):
        _fresh_names()
        mx.random.seed(seed)
        return train_imagenet.build_train_step("resnet50", device=mx.gpu(0))

    def run(step, items):
        for x, y in items:
            step(x, y)

    ref = build(SEED)
    run(ref, batches)
    want = ref.state_dict()
    del ref
    again = build(SEED)
    run(again, batches)
    control = _equal_trees(again.state_dict(), want)
    del again
    mgr = CheckpointManager(os.path.join(tmpdir, "trainstep"),
                            keep_last=CKPT_STEPS)
    first = build(SEED)
    for i, (x, y) in enumerate(batches):
        first(x, y)
        mgr.save(i + 1, first.state_dict())
    mgr.wait()
    del first
    step, state = mgr.restore(step=CKPT_RESTORE)
    resumed = build(SEED + 1)
    resumed(*batches[0])                   # shapes exist; then overwritten
    resumed.load_state_dict(state)
    check(resumed.num_update == CKPT_RESTORE, "restored num_update %d"
          % resumed.num_update)
    run(resumed, batches[CKPT_RESTORE:])
    bad = _equal_trees(resumed.state_dict(), want)
    mgr.close()
    return {"restored_step": step, "steps": CKPT_STEPS,
            "mismatches": bad[:8], "n_mismatches": len(bad),
            "uninterrupted_repeat_mismatches": len(control),
            "bitexact": not bad}


def _trainer_resume(tmpdir, batches):
    """The same for a bf16 net with multi_precision through gluon.Trainer,
    checkpointed as state_dict(net) + state_dict(trainer): the restored
    weights are bfloat16 and the 2 steps after the restore equal the
    uninterrupted 4 bit for bit."""
    import os

    from mxnet_tpu_torch import checkpoint, gluon
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    opt = dict(TRAINER_OPT, multi_precision=True)

    def build(seed):
        net = _resnet50(seed=seed, dtype="bfloat16")
        return net, gluon.Trainer(net.collect_params(), "sgd", dict(opt))

    def run(net, trainer, items):
        for x, y in items:
            _record_and_backward(net, x, y, cast_out=True)
            trainer.step(x.shape[0])

    def state(net, trainer):
        return {"net": checkpoint.state_dict(net),
                "trainer": checkpoint.state_dict(trainer)}

    def tensors(net, trainer):
        """Weights, and each optimizer state tensor (momentum, fp32
        master) by index."""
        return {"w": {k: p.data()._data.clone() for k, p in
                      net._collect_params_with_prefix().items()},
                "states": {"%d.%d" % (i, j): t.clone() for i, ts in
                           _state_tensors(trainer).items()
                           for j, t in enumerate(ts)}}

    net, tr = build(SEED)
    run(net, tr, batches)
    want = tensors(net, tr)
    del net, tr
    mgr = CheckpointManager(os.path.join(tmpdir, "trainer"),
                            keep_last=CKPT_STEPS)
    net, tr = build(SEED)
    sizes = None
    for i, item in enumerate(batches):
        run(net, tr, [item])
        st = state(net, tr)
        sizes = {"net_bytes": _state_bytes(st["net"]),
                 "trainer_pickle_bytes": len(st["trainer"]["opt_states"])}
        mgr.save(i + 1, st)
    mgr.wait()
    del net, tr
    step, st = mgr.restore(step=CKPT_RESTORE)
    net, tr = build(SEED + 1)
    checkpoint.load_state_dict(net, st["net"])
    checkpoint.load_state_dict(tr, st["trainer"])
    dtypes = sorted({str(p.data()._data.dtype)
                     for p in net.collect_params().values()})
    check(dtypes == ["torch.bfloat16"], "restored weights are %s" % dtypes)
    run(net, tr, batches[CKPT_RESTORE:])
    bad = _equal_trees(tensors(net, tr), want)
    mgr.close()
    return dict(sizes, restored_step=step, restored_dtypes=dtypes,
                mismatches=bad[:8], n_mismatches=len(bad), bitexact=not bad)


def _sigterm_in_update(tmpdir, x, y):
    """One ResNet-50 TrainStep step with a SIGTERM sent from inside its
    update loop (at parameter SIGTERM_AT_PARAM of 161): the preemption
    hook's commit equals the pre- or post-step state bit for bit, under
    that state's step."""
    import os
    import signal

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager, PreemptionHook
    from mxnet_tpu_torch.examples import train_imagenet

    mx.random.seed(SEED)
    step = train_imagenet.build_train_step("resnet50", device=mx.gpu(0))
    step(x, y)
    pre = step.state_dict()
    real = step._opt_update
    calls = {"n": 0}

    def update(*args):
        calls["n"] += 1
        if calls["n"] == SIGTERM_AT_PARAM:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*args)

    step._opt_update = update
    mgr = CheckpointManager(os.path.join(tmpdir, "sigterm"))
    hook = PreemptionHook(mgr, state_fn=step.state_dict,
                          step_fn=lambda: step.num_update, exit=False,
                          snapshot_retry_delay=0.05)
    t0 = time.perf_counter()
    with hook:
        step(x, y)
        deadline = time.monotonic() + 60
        while hook.saved_step is None and time.monotonic() < deadline:
            time.sleep(0.02)
    seconds = time.perf_counter() - t0
    check(hook.saved_step is not None, "the preemption save never landed")
    post = step.state_dict()
    saved, state = mgr.restore()

    def as_tensors(tree):
        return {k: as_tensors(v) if isinstance(v, dict) else
                (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k, v in tree.items()}

    got = as_tensors(state)
    got.pop("rng")
    whole = []
    for tag, want in (("pre", pre), ("post", post)):
        want = {k: v for k, v in want.items() if k != "rng"}
        if not _equal_trees(got, want) and saved == want["num_update"]:
            whole.append(tag)
    check(whole, "the SIGTERM commit (step %d) mixes two steps" % saved)
    mgr.close()
    return {"signal_at_parameter": SIGTERM_AT_PARAM,
            "committed_step": saved, "equals": whole[0],
            "seconds_to_commit": seconds}


def phase_checkpoint(card_line):
    """Phase 14: fault-tolerant checkpoints of ResNet-50 v1 training at
    full width (see the module docstring)."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_imagenet, train_resume

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    result = {"phase": "checkpoint", "card": card_line, "batch": 32,
              "optimizer": ["sgd", TRAINER_OPT], "keep_last":
              CKPT_KEEP_LAST, "fs": _fs_info(tmpdir)}
    try:
        _reset_all_launches()   # the main path starts here
        mx.random.seed(SEED)
        step = train_imagenet.build_train_step("resnet50", device=mx.gpu(0))
        (x, y), = _resnet_batches(1)
        step(x, y)
        state = step.state_dict()
        result["trainstep_state_bytes"] = _state_bytes(state)
        result["pageable_copy_ms"] = _pageable_copy_ms(state)
        del state
        # One warning per dropped save would bury the results: the
        # count is in each reading.
        import logging
        logging.getLogger("mxnet_tpu_torch.checkpoint.manager").setLevel(
            logging.ERROR)
        rates = [_ckpt_rate(step, x, y, tmpdir, every)
                 for every in (0, 1, 10, 0)]
        logging.getLogger("mxnet_tpu_torch.checkpoint.manager").setLevel(
            logging.NOTSET)
        result["rates"] = rates
        log("phase 14: img/s no saves %.1f/%.1f, every step %.1f, every 10 "
            "%.1f" % (rates[0]["img_s_b32"], rates[3]["img_s_b32"],
                      rates[1]["img_s_b32"], rates[2]["img_s_b32"]))
        del step
        torch.cuda.empty_cache()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            batches = _resnet_batches(CKPT_STEPS, seed=SEED + 1)
            result["trainstep_resume"] = _trainstep_resume(tmpdir, batches)
            bf16 = [(x.astype("bfloat16"), y) for x, y in batches]
            result["trainer_bf16_resume"] = _trainer_resume(tmpdir, bf16)
            del bf16
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
        result["trainer_bf16_state_bytes"] = \
            result["trainer_bf16_resume"]["net_bytes"] + \
            result["trainer_bf16_resume"]["trainer_pickle_bytes"]
        result["sigterm_in_update"] = _sigterm_in_update(tmpdir, x, y)
        t0 = time.perf_counter()
        result["train_resume_demo"] = train_resume.main(
            ["--steps", "24", "--kill-after", "8", "--step-delay", "0.1"])
        result["train_resume_demo"]["seconds"] = time.perf_counter() - t0
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    log(json.dumps(result))
    for key in ("trainstep_resume", "trainer_bf16_resume"):
        check(result[key]["bitexact"], "%s: the resumed run differs from "
              "the uninterrupted one at %s" % (key,
                                               result[key]["mismatches"]))
    check(result["train_resume_demo"]["bitexact"]
          and result["train_resume_demo"]["exit_code"] == 143,
          "train_resume: %s" % result["train_resume_demo"])
    return result


def _module_symbol(net, tmpdir):
    """The gluon net exported, with SoftmaxOutput(name="softmax") on its
    logits; and the exported arg/aux params."""
    import os

    import mxnet_tpu_torch as mx

    prefix = os.path.join(tmpdir, "resnet50_v1")
    net.export(prefix)
    sym = mx.sym.SoftmaxOutput(mx.sym.load(prefix + "-symbol.json"),
                               name="softmax")
    arg, aux = mx.model.load_params(prefix, 0, ctx=mx.gpu(0))
    return sym, arg, aux


class _FitWindows:
    """Batch-end callback timing Module.fit with benchmark_rate's
    protocol: `warmup` batches, then windows of `iters` batches, each
    closed by a synchronization of the card."""

    def __init__(self, batch, warmup=3, iters=16):
        self.batch, self.warmup, self.iters = batch, warmup, iters
        self.rates = []
        self.t0 = None

    def __call__(self, param):
        done = param.nbatch + 1
        if done < self.warmup or (done > self.warmup and
                                  (done - self.warmup) % self.iters):
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        if done > self.warmup:
            self.rates.append(self.batch * self.iters / (now - self.t0))
        self.t0 = now


def _peak_mb(fn):
    """(peak MB above the allocation before `fn`, absolute peak MB)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (peak - base) / 1e6, peak / 1e6


def _module_f64_parity(w0_net, tmpdir):
    """One SGD step at PARITY_BATCH in float64 from the same weights
    through Module (float64 arrays) and TrainStep(dtype="float64", fp32
    masters) on the card: loss-free comparison of weights, momentum and
    running stats with PARITY_LIMITS' float64 terms."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    lim = PARITY_LIMITS
    rng = np.random.default_rng(SEED + 7)
    xs = rng.random((PARITY_BATCH, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    sym, arg, aux = _module_symbol(w0_net, tmpdir)
    w0 = {n: v.asnumpy().astype(np.float64) for n, v in arg.items()}
    ts = TrainStep(w0_net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                   dict(TRAINER_OPT),
                   mesh=make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
                   dtype="float64")
    ts(xs, ys)
    params, states, t_aux = ts.state_to_host()
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[DataDesc("data", xs.shape, np.float64)],
             label_shapes=[DataDesc("softmax_label", ys.shape)])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAINER_OPT))
    mod.forward(DataBatch(data=[mx.nd.array(xs, ctx=mx.gpu(0),
                                            dtype="float64")],
                          label=[mx.nd.array(ys, ctx=mx.gpu(0))]),
                is_train=True)
    mod.backward()
    mod.update()
    m_arg, m_aux = mod.get_params()
    m_w = {n: v.asnumpy() for n, v in m_arg.items()}
    m_mom = {mod._param_names[i]: s.asnumpy()
             for i, s in mod._updater.states.items()}
    m_aux = {n: v.asnumpy() for n, v in m_aux.items()}
    check(all(v.dtype == np.float64 for v in m_w.values()),
          "the float64 Module holds %s weights"
          % {str(v.dtype) for v in m_w.values()})
    mom = _rel_max({n: s[0] for n, s in states.items()}, m_mom)
    auxe = _rel_max(t_aux, m_aux)
    weight_excess = max(
        float((np.abs(params[n] - w) - lim["f64_weight_rtol"]
               * np.abs(w)).max())
        / max(float(np.abs(w - w0[n]).max()), 1e-30)
        for n, w in m_w.items())
    reading = {"batch": PARITY_BATCH, "params": len(m_w),
               "momentum_rel_max": max(mom.values()),
               "aux_rel_max": max(auxe.values()),
               "weight_excess_over_step": weight_excess,
               "limits": {k: lim[k] for k in ("f64_momentum", "f64_aux",
                                              "f64_weight_rtol",
                                              "f64_weight_step")}}
    reading["within"] = (reading["momentum_rel_max"] <= lim["f64_momentum"]
                         and reading["aux_rel_max"] <= lim["f64_aux"]
                         and weight_excess <= lim["f64_weight_step"])
    return reading


def _module_resume(sym_arg_aux, batches, tmpdir):
    """Module.fit for 2 epochs of 2 b32 batches, against 1 epoch,
    save_checkpoint(save_optimizer_states=True) (module_checkpoint),
    Module.load and fit(begin_epoch=1): params and aux bit for bit."""
    import os

    import mxnet_tpu_torch as mx

    sym, arg, aux = sym_arg_aux
    gpu = mx.gpu(0)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])

    def it():
        return mx.io.NDArrayIter(x, y, batch_size=32, ctx=gpu)

    def fit(mod, begin, end, **kw):
        mod.fit(it(), begin_epoch=begin, num_epoch=end, optimizer="sgd",
                optimizer_params=dict(TRAINER_OPT), **kw)

    def params(mod):
        a, x_ = mod.get_params()
        return {"arg": {k: v._data.clone() for k, v in a.items()},
                "aux": {k: v._data.clone() for k, v in x_.items()}}

    ref = mx.mod.Module(sym, context=gpu)
    fit(ref, 0, 2, arg_params=arg, aux_params=aux)
    want = params(ref)
    del ref
    prefix = os.path.join(tmpdir, "module_resume")
    first = mx.mod.Module(sym, context=gpu)
    fit(first, 0, 1, arg_params=arg, aux_params=aux,
        epoch_end_callback=mx.callback.module_checkpoint(
            first, prefix, save_optimizer_states=True))
    del first
    resumed = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=gpu)
    fit(resumed, 1, 2)
    bad = _equal_trees(params(resumed), want)
    return {"epochs": 2, "batches_per_epoch": len(batches),
            "mismatches": bad[:8], "n_mismatches": len(bad),
            "states_bytes": os.path.getsize(prefix + "-0001.states"),
            "bitexact": not bad}


def phase_module(card_line, trainer_img_s):
    """Phase 15: ResNet-50 v1 at full width through Module.fit (see the
    module docstring)."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_module_")
    warmup, windows, iters = 3, 5, 16
    result = {"phase": "module", "card": card_line, "batch": 32,
              "optimizer": ["sgd", TRAINER_OPT], "windows": windows,
              "iters_per_window": iters, "eval_metric": "acc"}
    try:
        _reset_all_launches()   # the main path starts here
        net = _resnet50(seed=SEED)
        sym, arg, aux = _module_symbol(net, tmpdir)
        rng = np.random.default_rng(SEED)
        distinct = 8
        xs = rng.random((distinct * 32, 3, 224, 224), dtype=np.float32)
        ys = rng.integers(0, 1000, distinct * 32).astype(np.float32)
        n_batches = warmup + windows * iters
        reps = -(-n_batches // distinct)
        xs_all = np.tile(xs, (reps, 1, 1, 1))[:n_batches * 32]
        ys_all = np.tile(ys, reps)[:n_batches * 32]
        timer = _FitWindows(32, warmup, iters)
        # Bound and initialized first, so the peak below counts what a
        # batch adds, as the Trainer's does (its net exists before).
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (32, 3, 224, 224))],
                 label_shapes=[("softmax_label", (32,))])
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(TRAINER_OPT))

        def fit():
            mod.fit(mx.io.NDArrayIter(xs_all, ys_all, batch_size=32,
                                      ctx=mx.gpu(0)),
                    num_epoch=1, batch_end_callback=timer)

        t0 = time.perf_counter()
        peak = _peak_mb(fit)
        check(len(timer.rates) == windows, "timed %d windows"
              % len(timer.rates))
        result["module_fit"] = {
            "img_s_b32": sorted(timer.rates)[len(timer.rates) // 2],
            "img_s_windows": timer.rates, "seconds": time.perf_counter()
            - t0, "peak_mb_above_base": peak[0], "peak_mb": peak[1],
            "fused_plans": mod._fused_applier.num_compiles}
        check(mod._fused_applier.num_compiles >= 1, "Module.update did not "
              "take the fused path")
        del mod, xs_all, ys_all
        trainer_net = _resnet50(seed=SEED)
        trainer = gluon.Trainer(trainer_net.collect_params(), "sgd",
                                dict(TRAINER_OPT))
        x = mx.nd.array(xs[:32], ctx=mx.gpu(0))
        y = mx.nd.array(ys[:32], ctx=mx.gpu(0))

        def trainer_steps():
            for _ in range(3):
                _record_and_backward(trainer_net, x, y)
                trainer.step(32)

        peak = _peak_mb(trainer_steps)
        result["trainer_peak_mb_above_base"] = peak[0]
        result["trainer_peak_mb"] = peak[1]
        result["trainer_img_s_b32_phase11"] = trainer_img_s
        del trainer_net, trainer
        torch.cuda.empty_cache()
        log("phase 15: Module.fit %.1f img/s (Trainer %.1f in phase 11), "
            "peak %.0f MB above base (Trainer %.0f)"
            % (result["module_fit"]["img_s_b32"], trainer_img_s,
               result["module_fit"]["peak_mb_above_base"],
               result["trainer_peak_mb_above_base"]))
        result["f64_parity"] = _module_f64_parity(net, tmpdir)
        torch.cuda.empty_cache()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            batches = [(xs[i * 32:(i + 1) * 32], ys[i * 32:(i + 1) * 32])
                       for i in range(2)]
            result["resume"] = _module_resume((sym, arg, aux), batches,
                                              tmpdir)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    log(json.dumps(result))
    check(result["f64_parity"]["within"], "Module vs TrainStep float64 step: "
          "%s" % result["f64_parity"])
    check(result["resume"]["bitexact"], "Module resume differs at %s"
          % result["resume"]["mismatches"])
    return result


def main():
    t_start = time.perf_counter()
    card_line = phase_device()
    card = torch.cuda.get_device_name(0)
    phase_build()
    fwd = phase_kernels(card)
    dkv, dq = phase_backward_kernels(card)
    served = phase_attention_served()
    phase_resnet_served()
    trained, attn_step_ms = phase_attention_trained()
    synthetic = phase_resnet_trained()
    direct, tensors = phase_rtc_direct()
    rtc_entries = phase_rtc_kernels(card, tensors)
    ckpt = phase_checkpoint_served()
    trainer = phase_resnet_trainer(card_line)
    attn_trainer, attn_trainer_ms = phase_attention_trainer(card_line)
    pipeline = phase_input_pipeline(card_line, synthetic)
    ckpt_path = phase_checkpoint(card_line)
    module = phase_module(card_line, trainer["fp32"]["img_s_b32"])
    rtc_entries["scale_add"]["launches"] = direct["scale_add"]
    rtc_entries["relu"]["launches"] = direct["relu"]
    rtc_entries["bn_relu"]["launches"] = \
        ckpt["partitioned"]["bn_relu_launches"]
    rtc_entries["bn_relu"]["launches_by_path"] = {
        "checkpoint_served_partitioned":
            ckpt["partitioned"]["bn_relu_launches"],
        "checkpoint_served_plain": ckpt["plain"]["bn_relu_launches"]}
    rtc_entries["k4"]["launches"] = direct["rtc"] + \
        ckpt["partitioned"]["rtc_launches"] + ckpt["plain"]["rtc_launches"]
    rtc_entries["k4"]["launches_by_path"] = {
        "rtc_direct": direct["rtc"],
        "checkpoint_served_partitioned": ckpt["partitioned"]["rtc_launches"],
        "checkpoint_served_plain": ckpt["plain"]["rtc_launches"]}
    fwd["launches"] = served + trained[0] + attn_trainer[0]
    fwd["launches_by_path"] = {"attention_served": served,
                               "attention_trained": trained[0],
                               "resnet50_trained": 0,
                               "attention_trainer": attn_trainer[0],
                               "resnet50_trainer": 0}
    for entry, n, m in ((dkv, trained[1], attn_trainer[1]),
                        (dq, trained[2], attn_trainer[2])):
        entry["launches"] = n + m
        entry["launches_by_path"] = {"attention_trained": n,
                                     "resnet50_trained": 0,
                                     "attention_trainer": m,
                                     "resnet50_trainer": 0}
    rtc_list = [rtc_entries[k] for k in ("k4", "bn_relu", "scale_add",
                                         "relu")]
    # The input pipeline's (phase 13), the checkpoint's (14) and the
    # Module's (15) paths launch none of them.
    for path, read in (("input_pipeline", pipeline["launches"]),
                       ("checkpoint", ckpt_path["launches"]),
                       ("module", module["launches"])):
        for entry, n in zip([fwd, dkv, dq] + rtc_list,
                            list(read["k1_k2_k3"]) + [read["rtc"],
                                                      read["bn_relu"],
                                                      read["scale_add"],
                                                      read["relu"]]):
            entry.setdefault("launches_by_path", {})[path] = n
            entry["launches"] += n
    for entry in [fwd, dkv, dq] + rtc_list:
        entry["card"] = card_line
    log(json.dumps({"kernels": [fwd, dkv, dq] + rtc_list,
                    "attention_train_step_ms": attn_step_ms,
                    "attention_trainer_step_ms": attn_trainer_ms}))
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
