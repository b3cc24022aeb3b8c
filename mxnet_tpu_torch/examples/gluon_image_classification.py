"""Gluon imperative/hybrid image-classification driver, on the port.

Counterpart of ``examples/gluon_image_classification.py:28-121``
(reference: example/gluon/image_classification.py) — the canonical Gluon
training loop: a model-zoo network, ``gluon.data.DataLoader`` batches,
``gluon.Trainer`` with SGD momentum, ``autograd.record``/``backward``
per batch and an accuracy metric, with ``--mode hybrid`` running the
same code through the cached graph. With no dataset on disk the driver
builds the JAX driver's synthetic CIFAR-shaped set, whose classes are
separable colour bands, so both modes train anywhere::

    python -m mxnet_tpu_torch.examples.gluon_image_classification
    python -m mxnet_tpu_torch.examples.gluon_image_classification \\
        --num-workers 4 --pin-memory 1

It runs on ``gpu(0)`` unless ``--device cpu`` is given. The dataset
holds host arrays, so ``--num-workers`` forks workers that never touch
the card; ``--pin-memory 1`` copies each batch through pinned memory.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np


def synthetic_cifar(n, num_classes, rng, size=32):
    """Class = which band of the image is bright (the JAX driver's set)."""
    X = (rng.rand(n, 3, size, size) * 0.3).astype(np.float32)
    y = rng.randint(0, num_classes, n)
    band = size // num_classes
    if band < 1:
        raise ValueError(
            "num_classes=%d exceeds image size %d: the class-identifying "
            "band would be empty (unlearnable noise)" % (num_classes, size))
    for i in range(n):
        c = y[i]
        X[i, c % 3, c * band:(c + 1) * band, :] += 1.0
    return X, y.astype(np.float32)


def run(model="resnet18_v1", num_classes=4, num_examples=512, batch_size=32,
        epochs=5, lr=0.05, momentum=0.9, wd=1e-4, mode="hybrid",
        num_workers=0, pin_memory=False, seed=123, ctx=None):
    """Train and validate; returns {"epochs": [{"loss", "accuracy",
    "img_s"}, ...], "val_accuracy"} (loss: mean over the epoch)."""
    from .. import autograd, gluon, initializer, metric
    from .. import random as _random
    from ..context import gpu
    from ..gluon.model_zoo import vision

    ctx = ctx if ctx is not None else gpu(0)
    _random.seed(seed)
    rng = np.random.RandomState(seed)
    net = getattr(vision, model)(classes=num_classes)
    net.initialize(initializer.Xavier(magnitude=2.0), ctx=ctx)
    if mode == "hybrid":
        net.hybridize()

    X, y = synthetic_cifar(num_examples, num_classes, rng)
    cut = int(len(X) * 0.9)
    train_ds = gluon.data.ArrayDataset(X[:cut], y[:cut])
    val_ds = gluon.data.ArrayDataset(X[cut:], y[cut:])
    train_dl = gluon.data.DataLoader(
        train_ds, batch_size, last_batch="discard", num_workers=num_workers,
        pin_memory=pin_memory,
        sampler=gluon.data.RandomSampler(cut, rng=rng))
    val_dl = gluon.data.DataLoader(val_ds, batch_size)

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": momentum,
                             "wd": wd})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    history = []
    try:
        with ctx:
            for epoch in range(epochs):
                acc.reset()
                t0 = time.perf_counter()
                seen = 0
                total = None
                for xb, yb in train_dl:
                    with autograd.record():
                        out = net(xb)
                        loss = ce(out, yb)
                    loss.backward()
                    trainer.step(xb.shape[0])
                    acc.update([yb], [out])
                    batch_loss = loss.sum()
                    total = batch_loss if total is None else \
                        total + batch_loss
                    seen += xb.shape[0]
                _, train_acc = acc.get()
                record = {"loss": float(total.asscalar()) / seen,
                          "accuracy": train_acc,
                          "img_s": seen / (time.perf_counter() - t0)}
                history.append(record)
                logging.info("epoch %d: loss %.4f train-accuracy %.4f "
                             "(%.1f img/s)", epoch, record["loss"],
                             train_acc, record["img_s"])
            acc.reset()
            for xb, yb in val_dl:
                acc.update([yb], [net(xb)])
    finally:
        train_dl.close()
        val_dl.close()
    _, val_acc = acc.get()
    return {"epochs": history, "val_accuracy": val_acc}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Gluon image classification "
        "(reference example/gluon/image_classification.py)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--model", default="resnet18_v1")
    parser.add_argument("--num-classes", type=int, default=4)
    parser.add_argument("--num-examples", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--mode", default="hybrid",
                        choices=["imperative", "hybrid"])
    parser.add_argument("--num-workers", "-j", type=int, default=0)
    parser.add_argument("--pin-memory", type=int, default=0)
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = parser.parse_args(argv)
    from ..context import cpu, gpu

    logging.basicConfig(level=logging.INFO)
    result = run(args.model, args.num_classes, args.num_examples,
                 args.batch_size, args.epochs, args.lr, args.momentum,
                 args.wd, args.mode, args.num_workers, bool(args.pin_memory),
                 args.seed, ctx=cpu() if args.device == "cpu" else gpu(0))
    print("final-accuracy %.4f" % result["val_accuracy"])
    return result["val_accuracy"]


if __name__ == "__main__":
    main(sys.argv[1:])
