"""int8-vs-fp32 layer microbenchmark: does the int8 contraction beat
fp32? One JSON line per layer::

    python -m mxnet_tpu_torch.tools.quantized_bench [--batch 32] [--iters 20]
    python -m mxnet_tpu_torch.tools.quantized_bench --device cpu --batch 2 --channels 8

Counterpart of the repo's ``tools/quantized_bench.py``, with its JSON
keys, metric names and units. It times a ResNet-50-shaped convolution
(256 -> 256, 3x3 on 14x14) and the classifier's FullyConnected
(2048 -> 1000) in fp32 against the port's int8 operators
(``_contrib_quantized_conv`` and ``_contrib_quantized_fully_connected``:
the activation quantized with its calibrated range, an exact int8 x int8
contraction, ``torch._int_mm`` on a card, and one float32 rescale).

``--device``: ``auto`` (the current context, the port's default
``gpu(0)``), ``cpu`` or ``gpu``; a missing card raises. fp32 runs with
TF32 off (the line's ``"tf32": false``), as every fp32 comparison of
the port does. A time is the median of 5 windows of ``--iters`` plain
calls, each window closed by ``torch.cuda.synchronize()`` on a card.
The numbers only mean anything on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

CONV = {"side": 14, "kernel": (3, 3), "pad": (1, 1)}
FC = {"in": 2048, "out": 1000}
# The calibrated activation range and the weight scale of both layers.
ACT_RANGE = (-3.0, 3.0)
W_SCALE = 127.0 / 0.25
WINDOWS = 5


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_time(fn, *args, iters=20):
    """Median seconds of one call over WINDOWS windows of `iters`."""
    device = args[0].device
    fn(*args)
    _sync(device)
    rates = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(device)
        rates.append((time.perf_counter() - t0) / iters)
    return sorted(rates)[len(rates) // 2]


def quantize_weight(wf):
    """Symmetric int8 weights of a float32 numpy array, its largest
    magnitude at 127 (the JAX tool's rule, in numpy)."""
    scaled = wf * np.float32(127) / np.abs(wf).max()
    return np.clip(np.round(scaled), -127, 127).astype(np.int8)


def layers(batch=32, channels=256, seed=0):
    """The tool's inputs as numpy arrays, from `seed`: the conv's data,
    fp32 and int8 weights, then the FC's."""
    rng = np.random.RandomState(seed)
    side = CONV["side"]
    x = rng.rand(batch, channels, side, side).astype(np.float32)
    wf = (rng.randn(channels, channels, *CONV["kernel"]) * 0.05).astype(
        np.float32)
    xf = rng.rand(batch, FC["in"]).astype(np.float32)
    wf2 = (rng.randn(FC["out"], FC["in"]) * 0.05).astype(np.float32)
    return {"conv": (x, wf, quantize_weight(wf)),
            "fc": (xf, wf2, quantize_weight(wf2))}


def conv_fns(channels):
    """(fp32, int8) callables of the conv over torch tensors."""
    from ..ops.nn import _convolution
    from ..ops.quantization_ops import _quantized_conv

    def f32(a, w):
        return _convolution(a, w, None, kernel=CONV["kernel"],
                            pad=CONV["pad"], num_filter=channels,
                            no_bias=True)

    def i8(a, w):
        return _quantized_conv(a, w, kernel=CONV["kernel"], pad=CONV["pad"],
                               num_filter=channels, no_bias=True,
                               min_data=ACT_RANGE[0], max_data=ACT_RANGE[1],
                               w_scale=W_SCALE)

    return f32, i8


def fc_fns():
    """(fp32, int8) callables of the FC over torch tensors."""
    from ..ops.quantization_ops import _quantized_fc

    def f32(a, w):
        return a @ w.t()

    def i8(a, w):
        return _quantized_fc(a, w, num_hidden=FC["out"], no_bias=True,
                             min_data=ACT_RANGE[0], max_data=ACT_RANGE[1],
                             w_scale=W_SCALE)

    return f32, i8


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN and cuBLAS inside the block, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def run(device, batch=32, channels=256, iters=20, seed=0):
    """``[(metric, fp32_seconds, int8_seconds)]`` of the two layers on
    the torch `device`."""
    data = layers(batch, channels, seed)
    rows = []
    with tf32_off():
        for metric, key, (f32, i8) in (
                ("conv3x3_int8_speedup", "conv", conv_fns(channels)),
                ("fc2048x1000_int8_speedup", "fc", fc_fns())):
            x, wf, wq = (torch.from_numpy(a).to(device) for a in data[key])
            t_f = _median_time(f32, x, wf, iters=iters)
            t_q = _median_time(i8, x, wq, iters=iters)
            rows.append((metric, t_f, t_q))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="fp32 against int8 at a ResNet-50 conv and FC shape")
    ap.add_argument("--device", default="auto",
                    choices=["auto", "cpu", "gpu"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--channels", type=int, default=256,
                    help="conv width (drop for cpu smoke runs)")
    args = ap.parse_args(argv)

    from ..context import current_context
    from ..util import platform_context

    with platform_context(args.device):
        ctx = current_context()
    device = ctx.torch_device
    for metric, t_f, t_q in run(device, args.batch, args.channels,
                                args.iters):
        print(json.dumps({"metric": metric,
                          "value": round(t_f / t_q, 4), "unit": "x",
                          "fp32_ms": round(t_f * 1e3, 3),
                          "int8_ms": round(t_q * 1e3, 3),
                          "vs_baseline": round(t_f / t_q, 4),
                          "tf32": False, "device": str(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
