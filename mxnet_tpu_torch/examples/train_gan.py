"""Adversarial training with two optimizers, on the port.

Counterpart of ``examples/train_gan.py`` (reference: example/gan): a
generator and a discriminator each own a ``gluon.Trainer``; the
discriminator trains on real and generated batches through
``SigmoidBinaryCrossEntropyLoss``, the generator trains through the
discriminator's graph (which is not stepped). The layers are Dense,
``LeakyReLU`` and a ``HybridLambda`` tanh. "Real" samples are 8x8 blob
images made from the seed; nothing is downloaded::

    python -m mxnet_tpu_torch.examples.train_gan --epochs 2 --batches 8

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


def build_generator(latent):
    net = gluon.nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        net.add(gluon.nn.Dense(64, activation="relu", in_units=latent),
                gluon.nn.Dense(64, activation="relu", in_units=64),
                gluon.nn.Dense(64, in_units=64),
                gluon.nn.HybridLambda(lambda F, x: F.tanh(x)))
    return net


def build_discriminator():
    net = gluon.nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(gluon.nn.Dense(64, in_units=64),
                gluon.nn.LeakyReLU(0.2),
                gluon.nn.Dense(32, in_units=64),
                gluon.nn.LeakyReLU(0.2),
                gluon.nn.Dense(1, in_units=32))
    return net


def real_batch(rng, batch_size):
    """Blobby 8x8 images: a bright gaussian bump at a random position."""
    yy, xx = np.mgrid[0:8, 0:8]
    cy = rng.uniform(2, 6, size=(batch_size, 1, 1))
    cx = rng.uniform(2, 6, size=(batch_size, 1, 1))
    img = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
    return (img * 2 - 1).reshape(batch_size, 64).astype(np.float32)


def run(epochs=3, batches=16, batch_size=32, latent=16, lr=2e-3, seed=42,
        ctx=None):
    """Train; returns {"d_loss": [per epoch], "g_loss": [...],
    "fake_mean", "real_mean"}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    history = {"d_loss": [], "g_loss": []}
    with ctx:
        gen = build_generator(latent)
        disc = build_discriminator()
        gen.initialize(mx.init.Normal(0.05), ctx=ctx)
        disc.initialize(mx.init.Normal(0.05), ctx=ctx)
        gen.hybridize()
        disc.hybridize()
        g_tr = gluon.Trainer(gen.collect_params(), "adam",
                             {"learning_rate": lr, "beta1": 0.5})
        d_tr = gluon.Trainer(disc.collect_params(), "adam",
                             {"learning_rate": lr, "beta1": 0.5})
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        bs = batch_size
        ones = mx.nd.ones((bs,))
        zeros = mx.nd.zeros((bs,))
        for epoch in range(epochs):
            d_losses, g_losses = [], []
            for _ in range(batches):
                real = mx.nd.array(real_batch(rng, bs))
                z = mx.nd.array(rng.randn(bs, latent).astype(np.float32))
                # The discriminator: real -> 1, fake -> 0 (the fake is
                # made outside the recorded graph).
                fake = gen(z)
                with autograd.record():
                    d_loss = (loss_fn(disc(real), ones)
                              + loss_fn(disc(fake), zeros)).sum()
                d_loss.backward()
                d_tr.step(bs)
                # The generator: fool the discriminator.
                z = mx.nd.array(rng.randn(bs, latent).astype(np.float32))
                with autograd.record():
                    g_loss = loss_fn(disc(gen(z)), ones).sum()
                g_loss.backward()
                g_tr.step(bs)
                d_losses.append(float(d_loss.asnumpy()) / bs)
                g_losses.append(float(g_loss.asnumpy()) / bs)
            history["d_loss"].append(float(np.mean(d_losses)))
            history["g_loss"].append(float(np.mean(g_losses)))
            print("epoch %d  d_loss %.4f  g_loss %.4f"
                  % (epoch, history["d_loss"][-1], history["g_loss"][-1]),
                  flush=True)
        # The generator's output moved toward the data's mean (the blobs
        # have a mean near -0.55).
        z = mx.nd.array(rng.randn(256, latent).astype(np.float32))
        fake_mean = float(gen(z).asnumpy().mean())
    real_mean = float(real_batch(rng, 256).mean())
    print("fake mean %.3f vs real mean %.3f" % (fake_mean, real_mean),
          flush=True)
    if not np.isfinite(history["d_loss"][-1]) or not np.isfinite(fake_mean):
        raise SystemExit("GAN training produced non-finite values")
    return dict(history, fake_mean=fake_mean, real_mean=real_mean)


def main(argv=None):
    ap = argparse.ArgumentParser(description="two-optimizer GAN loop")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batches", type=int, default=16,
                    help="batches per epoch")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.batches, args.batch_size, args.latent,
               args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
