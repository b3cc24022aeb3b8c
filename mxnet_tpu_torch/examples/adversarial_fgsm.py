"""FGSM adversarial examples: gradients with respect to the input, on
the port.

Counterpart of ``examples/adversarial_fgsm.py`` (reference:
example/adversary): train a small classifier, then perturb the test
inputs by ``eps * sign(dLoss/dInput)`` and watch the accuracy fall,
through ``x.attach_grad()`` and ``loss.backward()`` filling a
non-parameter leaf's ``.grad``. Two classes of synthetic images, made
from the seed: the blob's half decides the class::

    python -m mxnet_tpu_torch.examples.adversarial_fgsm --epochs 3

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


def make_data(rng, n):
    """Class 0: a bright blob in the left half; class 1: the right."""
    imgs = rng.rand(n, 1, 12, 12).astype(np.float32) * 0.3
    labels = rng.randint(0, 2, n)
    for i, lab in enumerate(labels):
        col = rng.randint(0, 4) if lab == 0 else rng.randint(8, 12) - 2
        row = rng.randint(0, 10)
        imgs[i, 0, row:row + 3, col:col + 3] += 0.7
    return imgs, labels.astype(np.float32)


def accuracy(net, X, Y):
    pred = net(mx.nd.array(X)).asnumpy().argmax(1)
    return float((pred == Y).mean())


def run(epochs=4, train=512, test=256, batch_size=64, eps=0.25, seed=0,
        ctx=None):
    """Train, then attack; returns {"loss": [per epoch], "clean_acc",
    "adv_acc"}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    Xtr, Ytr = make_data(rng, train)
    Xte, Yte = make_data(rng, test)
    losses = []
    with ctx:
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(2),
                gluon.nn.Flatten(),
                gluon.nn.Dense(2))
        net.initialize(mx.init.Xavier(), ctx=ctx)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 5e-3})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        bs = batch_size
        for epoch in range(epochs):
            perm = rng.permutation(train)
            total = 0.0
            for off in range(0, train - bs + 1, bs):
                sel = perm[off:off + bs]
                with autograd.record():
                    loss = loss_fn(net(mx.nd.array(Xtr[sel])),
                                   mx.nd.array(Ytr[sel])).sum()
                loss.backward()
                tr.step(bs)
                total += float(loss.asnumpy())
            losses.append(total / train)
            print("epoch %d  loss %.4f" % (epoch, losses[-1]), flush=True)
        clean_acc = accuracy(net, Xte, Yte)
        # FGSM: one step on the input, up the loss.
        x = mx.nd.array(Xte)
        x.attach_grad()
        with autograd.record():
            loss = loss_fn(net(x), mx.nd.array(Yte)).sum()
        loss.backward()
        x_adv = (x + eps * mx.nd.sign(x.grad)).clip(0.0, 1.0)
        adv_acc = accuracy(net, x_adv.asnumpy(), Yte)
    print("clean accuracy %.3f  adversarial accuracy %.3f (eps=%.2f)"
          % (clean_acc, adv_acc, eps), flush=True)
    if clean_acc < 0.85:
        raise SystemExit("classifier failed to train (%.3f)" % clean_acc)
    if adv_acc > clean_acc - 0.1:
        raise SystemExit("FGSM perturbation had no effect "
                         "(%.3f vs %.3f)" % (adv_acc, clean_acc))
    return {"loss": losses, "clean_acc": clean_acc, "adv_acc": adv_acc}


def main(argv=None):
    ap = argparse.ArgumentParser(description="FGSM adversarial examples")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--train", type=int, default=512)
    ap.add_argument("--test", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--eps", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.train, args.test, args.batch_size,
               args.eps, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
