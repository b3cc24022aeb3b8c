"""Convolutional autoencoder: unsupervised reconstruction, on the port.

Counterpart of ``examples/train_autoencoder.py`` (reference:
example/autoencoder): encode to a small bottleneck with strided
``Conv2D``, decode back with ``Conv2DTranspose``, train on the L2
reconstruction loss; then nearest neighbours in code space must share
blob geometry. The data are two-blob images made from the seed::

    python -m mxnet_tpu_torch.examples.train_autoencoder --epochs 4

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

SIZE = 16


class ConvAE(gluon.HybridBlock):
    def __init__(self, code=8, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.enc = gluon.nn.HybridSequential()
            self.enc.add(
                gluon.nn.Conv2D(8, 3, strides=2, padding=1,
                                activation="relu"),     # 16 -> 8
                gluon.nn.Conv2D(16, 3, strides=2, padding=1,
                                activation="relu"),     # 8 -> 4
                gluon.nn.Flatten(),
                gluon.nn.Dense(code))
            self.dec_fc = gluon.nn.Dense(16 * 4 * 4, activation="relu")
            self.dec = gluon.nn.HybridSequential()
            self.dec.add(
                gluon.nn.Conv2DTranspose(8, 4, strides=2, padding=1,
                                         activation="relu"),  # 4 -> 8
                gluon.nn.Conv2DTranspose(1, 4, strides=2, padding=1))
                                                              # 8 -> 16

    def encode(self, x):
        return self.enc(x)

    def hybrid_forward(self, F, x):
        z = self.enc(x)
        h = self.dec_fc(z).reshape((-1, 16, 4, 4))
        return self.dec(h)


def make_data(rng, n):
    imgs = np.zeros((n, 1, SIZE, SIZE), np.float32)
    pos = rng.randint(2, SIZE - 4, (n, 2))
    for i, (y, x) in enumerate(pos):
        imgs[i, 0, y:y + 3, x:x + 3] = 1.0
        imgs[i, 0, (y + 7) % (SIZE - 3), (x + 5) % (SIZE - 3)] = 0.8
    return imgs + rng.rand(n, 1, SIZE, SIZE).astype(np.float32) * 0.05


def run(epochs=6, train=1024, batch_size=64, lr=2e-3, seed=4, ctx=None):
    """Train; returns {"recon_loss": [per epoch], "nn_pix", "rand_pix"}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    X = make_data(rng, train)
    losses = []
    with ctx:
        net = ConvAE()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
        l2 = gluon.loss.L2Loss()
        bs = batch_size
        for epoch in range(epochs):
            perm = rng.permutation(train)
            tot = 0.0
            n_seen = 0
            for off in range(0, train - bs + 1, bs):
                xb = mx.nd.array(X[perm[off:off + bs]])
                with autograd.record():
                    loss = l2(net(xb), xb).sum()
                loss.backward()
                tr.step(bs)
                tot += float(loss.asnumpy())
                n_seen += bs
            losses.append(tot / n_seen)
            print("epoch %d  recon_loss %.5f" % (epoch, losses[-1]),
                  flush=True)
        # The bottleneck as a representation: the nearest neighbour in
        # code space must be closer in pixels than a random pair.
        Xv = make_data(rng, 128)
        codes = net.encode(mx.nd.array(Xv)).asnumpy()
    d2 = ((codes[:, None] - codes[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = d2.argmin(1)
    flat = Xv.reshape(128, -1)
    nn_pix = float(np.linalg.norm(flat - flat[nn], axis=1).mean())
    rand_pix = float(np.linalg.norm(flat - flat[rng.permutation(128)],
                                    axis=1).mean())
    first, last = losses[0], losses[-1]
    print("recon %.5f -> %.5f   nn-pix %.3f vs random %.3f"
          % (first, last, nn_pix, rand_pix), flush=True)
    if not (np.isfinite(last) and last < first * 0.75):
        raise SystemExit("autoencoder reconstruction did not improve")
    if not nn_pix < rand_pix * 0.9:
        raise SystemExit("bottleneck codes carry no structure "
                         "(%.3f vs %.3f)" % (nn_pix, rand_pix))
    return {"recon_loss": losses, "nn_pix": nn_pix, "rand_pix": rand_pix}


def main(argv=None):
    ap = argparse.ArgumentParser(description="convolutional autoencoder")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.train, args.batch_size, args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
