"""Where the time of a training step goes on one CUDA card.

Run on a machine with a CUDA card::

    python3 -m mxnet_tpu_torch.profile_training

For each training step of ``chip_smoke.py`` — ResNet-50 v1 at batch 32
in fp32 (TF32 off) and bf16, and the self-attention layer (16 heads x
64, T 2048, batch 8, bf16) — on a batch already on the card, it prints
one JSON line with the fields of :mod:`mxnet_tpu_torch.profile_serving`:
``wall_ms`` (host clock per step, the card synchronised at the end of
the window), ``enqueue_ms`` (host time of the call itself), ``device_ms``
(CUDA kernel time per step from ``torch.profiler``), ``idle_share``
(``1 - device_ms / wall_ms``) and ``top_kernels``.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .profile_serving import _profile


def main():
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention
    from mxnet_tpu_torch.examples.train_imagenet import build_train_step
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    mx.random.seed(0)
    x = torch.from_numpy(rng.random((32, 3, 224, 224),
                                    dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, 32).astype(np.float32)).cuda()
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        step = build_train_step("resnet50", 1000, dtype, mx.gpu(0))
        step(x, y)  # materialize
        _profile("resnet50_v1 train %s b32" % tag, lambda: step(x, y))
        del step

    block = SelfAttention(1024, heads=16)
    block.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    step = TrainStep(block, gluon.loss.L2Loss(), "sgd",
                     {"learning_rate": 10.0, "momentum": 0.9},
                     mesh=make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
                     dtype="bfloat16")
    xa = torch.from_numpy(rng.standard_normal((8, 2048, 1024),
                                              dtype=np.float32)).cuda()
    ya = torch.from_numpy(rng.standard_normal((8, 2048, 1024),
                                              dtype=np.float32)).cuda()
    _profile("self-attention train bf16 b8 T2048", lambda: step(xa, ya))
    return 0


if __name__ == "__main__":
    sys.exit(main())
