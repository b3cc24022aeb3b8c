"""Fully-convolutional segmentation, on the port.

Counterpart of ``examples/train_fcn_segmentation.py`` (reference:
example/fcn-xs): an FCN encoder, ``Conv2DTranspose`` upsampling back to
the input's resolution, per-pixel ``SoftmaxCrossEntropyLoss`` over a
label image, and mean-IoU evaluation. The scenes, made from the seed,
hold a filled square (class 1) and a filled disc (class 2) on noise::

    python -m mxnet_tpu_torch.examples.train_fcn_segmentation --epochs 4

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

SIZE = 24
NCLS = 3


class MiniFCN(gluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.enc = gluon.nn.HybridSequential()
            self.enc.add(
                gluon.nn.Conv2D(12, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(2),                      # 24 -> 12
                gluon.nn.Conv2D(24, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(2),                      # 12 -> 6
                gluon.nn.Conv2D(24, 3, padding=1, activation="relu"))
            self.up = gluon.nn.HybridSequential()
            self.up.add(
                gluon.nn.Conv2DTranspose(16, 4, strides=2, padding=1,
                                         activation="relu"),  # 6 -> 12
                gluon.nn.Conv2DTranspose(NCLS, 4, strides=2,
                                         padding=1))          # 12 -> 24

    def hybrid_forward(self, F, x):
        return self.up(self.enc(x))        # (N, NCLS, H, W)


def make_scene(rng):
    img = rng.rand(3, SIZE, SIZE).astype(np.float32) * 0.2
    lab = np.zeros((SIZE, SIZE), np.float32)
    s = rng.randint(5, 9)
    y, x = rng.randint(0, SIZE - s, 2)
    img[0, y:y + s, x:x + s] += 0.7
    lab[y:y + s, x:x + s] = 1
    cy, cx = rng.randint(6, SIZE - 6, 2)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(9, 20)
    img[1][disc] += 0.7
    lab[disc] = 2
    return img, lab


def mean_iou(pred, lab):
    ious = []
    for c in range(NCLS):
        inter = ((pred == c) & (lab == c)).sum()
        union = ((pred == c) | (lab == c)).sum()
        if union:
            ious.append(inter / union)
    return float(np.mean(ious))


def run(epochs=6, train=512, batch_size=32, lr=3e-3, seed=6, ctx=None):
    """Train; returns {"loss": [per epoch], "mean_iou": [per epoch]}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    data = [make_scene(rng) for _ in range(train + 128)]
    X = np.stack([d[0] for d in data[:train]])
    Y = np.stack([d[1] for d in data[:train]])
    Xv = np.stack([d[0] for d in data[train:]])
    Yv = np.stack([d[1] for d in data[train:]])
    history = {"loss": [], "mean_iou": []}
    with ctx:
        net = MiniFCN()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
        # axis=1: class scores along the channels, the label an image.
        ce = gluon.loss.SoftmaxCrossEntropyLoss(axis=1, sparse_label=True)
        bs = min(batch_size, train)
        for epoch in range(epochs):
            perm = rng.permutation(train)
            tot = 0.0
            n_seen = 0
            for off in range(0, train - bs + 1, bs):
                sel = perm[off:off + bs]
                with autograd.record():
                    loss = ce(net(mx.nd.array(X[sel])),
                              mx.nd.array(Y[sel])).sum()
                loss.backward()
                tr.step(bs)
                tot += float(loss.asnumpy())
                n_seen += bs
            with autograd.pause(train_mode=False):
                pred = net(mx.nd.array(Xv)).asnumpy().argmax(1)
            history["loss"].append(tot / n_seen)
            history["mean_iou"].append(mean_iou(pred, Yv))
            print("epoch %d  loss %.4f  mean-IoU %.3f"
                  % (epoch, history["loss"][-1], history["mean_iou"][-1]),
                  flush=True)
    if history["mean_iou"][-1] < 0.5:
        raise SystemExit("segmentation mean-IoU too low: %.3f"
                         % history["mean_iou"][-1])
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description="FCN segmentation")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--train", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.train, args.batch_size, args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
