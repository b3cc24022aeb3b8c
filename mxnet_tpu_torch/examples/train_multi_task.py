"""Multi-task learning: one trunk, two heads, two losses, on the port.

Counterpart of ``examples/train_multi_task.py`` (reference:
example/multi-task): a shared HybridBlock trunk feeds a classification
head and a regression head, trained by one backward over a weighted sum
of their losses, with a metric per task. Each synthetic image, made from
the seed, holds one bright 3x3 blob: task A names its quadrant (4
classes), task B regresses its x position::

    python -m mxnet_tpu_torch.examples.train_multi_task --epochs 4

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


class MultiTaskNet(gluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.trunk = gluon.nn.HybridSequential()
            self.trunk.add(gluon.nn.Conv2D(8, 3, padding=1,
                                           activation="relu"),
                           gluon.nn.MaxPool2D(2),
                           gluon.nn.Flatten(),
                           gluon.nn.Dense(32, activation="relu"))
            self.cls_head = gluon.nn.Dense(4)
            self.reg_head = gluon.nn.Dense(1)

    def hybrid_forward(self, F, x):
        z = self.trunk(x)
        return self.cls_head(z), self.reg_head(z)


def make_data(rng, n):
    imgs = rng.rand(n, 1, 12, 12).astype(np.float32) * 0.2
    quad = np.zeros(n, np.float32)
    xpos = np.zeros(n, np.float32)
    for i in range(n):
        y = rng.randint(0, 10)
        x = rng.randint(0, 10)
        imgs[i, 0, y:y + 3, x:x + 3] = 1.0
        quad[i] = (1 if x >= 5 else 0) + (2 if y >= 5 else 0)
        xpos[i] = x / 9.0
    return imgs, quad, xpos


def run(epochs=5, train=1024, batch_size=64, lr=2e-3, task_weight=0.5,
        seed=2, ctx=None):
    """Train; returns {"loss", "quad_acc", "xpos_mae"}, each per epoch."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    X, Yc, Yr = make_data(rng, train)
    Xv, Ycv, Yrv = make_data(rng, 256)
    history = {"loss": [], "quad_acc": [], "xpos_mae": []}
    with ctx:
        net = MultiTaskNet()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        l2 = gluon.loss.L2Loss()
        bs = batch_size
        for epoch in range(epochs):
            perm = rng.permutation(train)
            tot = 0.0
            for off in range(0, train - bs + 1, bs):
                sel = perm[off:off + bs]
                with autograd.record():
                    logits, reg = net(mx.nd.array(X[sel]))
                    loss = (ce(logits, mx.nd.array(Yc[sel])).sum()
                            + task_weight
                            * l2(reg, mx.nd.array(Yr[sel][:, None])).sum())
                loss.backward()
                tr.step(bs)
                tot += float(loss.asnumpy())
            logits, reg = net(mx.nd.array(Xv))
            history["quad_acc"].append(
                float((logits.asnumpy().argmax(1) == Ycv).mean()))
            history["xpos_mae"].append(
                float(np.abs(reg.asnumpy()[:, 0] - Yrv).mean()))
            history["loss"].append(tot / ((train // bs) * bs))
            print("epoch %d  loss %.4f  quad-acc %.3f  xpos-mae %.4f"
                  % (epoch, history["loss"][-1], history["quad_acc"][-1],
                     history["xpos_mae"][-1]), flush=True)
    acc, mae = history["quad_acc"][-1], history["xpos_mae"][-1]
    if acc < 0.8 or mae > 0.15:
        raise SystemExit("multi-task heads failed to learn "
                         "(acc %.3f, mae %.4f)" % (acc, mae))
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-task learning")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--task-weight", type=float, default=0.5,
                    help="weight of the regression loss")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.train, args.batch_size, args.lr,
               args.task_weight, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
