"""Where the time of a training step goes on one CUDA card.

Run on a machine with a CUDA card::

    python3 -m mxnet_tpu_torch.profile_training

For each training step of ``chip_smoke.py`` — ResNet-50 v1 at batch 32
in fp32 (TF32 off) and bf16, and the self-attention layer (16 heads x
64, T 2048, batch 8, bf16), each through ``parallel.TrainStep`` and
through ``gluon.Trainer`` (``autograd.record``/``backward``/
``trainer.step``, hybridized, fused update; ResNet-50 with SGD
momentum, bf16 as ``net.cast("bfloat16")`` with ``multi_precision``;
the attention layer with adam) — on a batch already on the card, it prints
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
    del step
    _profile_trainers(rng)
    return 0


def _profile_trainers(rng):
    """The same steps through gluon.Trainer."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def trainer_step(net, trainer, x, y, loss_fn, cast_out):
        def call():
            with autograd.record():
                out = net(x)
                if cast_out:
                    out = out.astype("float32")
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(x.shape[0])
        return call

    xs = rng.random((32, 3, 224, 224), dtype=np.float32)
    y = nd.array(rng.integers(0, 1000, 32).astype(np.float32),
                 ctx=mx.gpu(0))
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        mx.random.seed(0)
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=mx.gpu(0))
        with autograd.pause():
            net(nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
        if dtype:
            net.cast(dtype)
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4,
                                 "multi_precision": dtype is not None})
        x = nd.array(xs, ctx=mx.gpu(0), dtype=dtype or "float32")
        _profile("resnet50_v1 gluon.Trainer %s b32" % tag,
                 trainer_step(net, trainer, x, y,
                              gluon.loss.SoftmaxCrossEntropyLoss(),
                              dtype is not None))
        del net, trainer
    mx.random.seed(0)
    block = SelfAttention(1024, heads=16)
    block.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    block.cast("bfloat16")
    block.hybridize()
    trainer = gluon.Trainer(block.collect_params(), "adam",
                            {"learning_rate": 1e-3, "multi_precision": True})
    xa = nd.array(rng.standard_normal((8, 2048, 1024), dtype=np.float32),
                  ctx=mx.gpu(0), dtype="bfloat16")
    ya = nd.array(rng.standard_normal((8, 2048, 1024), dtype=np.float32),
                  ctx=mx.gpu(0))
    _profile("self-attention gluon.Trainer adam bf16 b8 T2048",
             trainer_step(block, trainer, xa, ya, gluon.loss.L2Loss(), True))


if __name__ == "__main__":
    sys.exit(main())
