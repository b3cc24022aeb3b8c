"""Where the time of the served functions goes on one CUDA card.

Run from the repository root on a machine with a CUDA card::

    python3 -m mxnet_tpu_torch.profile_serving

For each served function of ``chip_smoke.py`` — ResNet-50 v1 at batch 32
in fp32 (TF32 off) and bf16, the flash-attention function at bucket 8,
and ResNet-50 v1 served from its exported checkpoint at batch 32 (the
bucket Executor of ``InferenceServer.from_checkpoint``), plain and
partitioned by the ``fused_bn_relu`` subgraph backend — on a batch
already on the card, it prints one JSON line:

- ``wall_ms``: host clock per call, the card synchronised at the end of
  the window;
- ``enqueue_ms``: host time of the call itself, before synchronising
  (the host's dispatch cost);
- ``device_ms``: CUDA kernel time per call from ``torch.profiler``;
- ``idle_share``: ``1 - device_ms / wall_ms``, the share of the wall
  time the card had no kernel running;
- ``top_kernels``: the kernels with the most device time per call.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ITERS = 10


def _profile(tag, call):
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue = 0.0
    for _ in range(ITERS):
        e0 = time.perf_counter()
        call()
        enqueue += time.perf_counter() - e0
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / ITERS
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(ITERS):
            call()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        # Kernel entries only: a CPU op's device time repeats its kernels.
        if str(evt.device_type).endswith("CUDA"):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                evt.self_device_time_total
    device_ms = sum(kernels.values()) / 1e3 / ITERS
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({
        "profile": tag, "iters": ITERS, "wall_ms": wall * 1e3,
        "enqueue_ms": enqueue / ITERS * 1e3,
        "device_ms": device_ms if kernels else None,
        "idle_share": 1 - device_ms / (wall * 1e3) if kernels else None,
        "top_kernels": [[k[:90], v / 1e3 / ITERS] for k, v in top],
    }), flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.parameter import override

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    batch = nd.array(rng.random((32, 3, 224, 224), dtype=np.float32),
                     ctx=mx.gpu(0))
    with torch.no_grad(), autograd.pause():
        net(batch[:1])  # deferred shape inference
        pobjs = list(net.collect_params().values())
        weights = {p: p.data().astype("bfloat16") for p in pobjs}

        def bf16():
            with override(weights):
                net(batch.astype("bfloat16"))

        _profile("resnet50_v1 fp32 b32", lambda: net(batch))
        _profile("resnet50_v1 bf16 b32", bf16)

        x = nd.array(rng.standard_normal((8, 3, 16, 2048, 64),
                                         dtype=np.float32), ctx=mx.gpu(0))

        def attention():
            xb = x.astype("bfloat16")
            nd.contrib.flash_attention(xb[:, 0], xb[:, 1], xb[:, 2],
                                       causal=True)

        _profile("flash_attention served fn b8", attention)

    _profile_checkpoint(net, batch)
    return 0


def _profile_checkpoint(net, batch):
    """The checkpoint-served ResNet-50 at b32, plain and partitioned: the
    bucket model of from_checkpoint, called as the server's worker calls
    it."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.examples import fused_bn_relu

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    try:
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix)
        for tag, backend in (("plain", None),
                             ("partitioned", fused_bn_relu.BACKEND)):
            if backend:
                os.environ["MXNET_SUBGRAPH_BACKEND"] = backend
            try:
                srv = serving.InferenceServer.from_checkpoint(
                    prefix, 0, item_shape=tuple(batch.shape[1:]),
                    buckets=(batch.shape[0],), ctx=mx.gpu(0), start=False)
            finally:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            _profile("resnet50_v1 from_checkpoint %s b32" % tag,
                     lambda: srv._model(batch))
            srv.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
