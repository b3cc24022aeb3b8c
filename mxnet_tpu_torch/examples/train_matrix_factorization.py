#!/usr/bin/env python
"""Matrix factorization recommender: sparse embeddings and the lazy
optimizer, on the port.

Counterpart of ``examples/train_matrix_factorization.py`` (reference:
example/recommenders, demo1-MF): ratings are predicted as
``<user_vec, item_vec>`` plus biases, trained on (user, item, rating)
triples through ``Embedding(..., sparse_grad=True)``, whose row-sparse
gradients touch only the batch's rows, and the lazy SGD/Adam update
(only those rows and their states move, the reference's
``lazy_update`` contract, optimizer_op.cc).

The ratings are synthetic, made from the seed: a random low-rank rating
matrix with noise. A CI-sized run::

    python -m mxnet_tpu_torch.examples.train_matrix_factorization --epochs 3

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


class MFNet(gluon.HybridBlock):
    """Biased matrix factorization (demo1-MF's model)."""

    def __init__(self, num_users, num_items, rank, sparse_grad=True,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.user = gluon.nn.Embedding(num_users, rank,
                                           sparse_grad=sparse_grad)
            self.item = gluon.nn.Embedding(num_items, rank,
                                           sparse_grad=sparse_grad)
            self.user_b = gluon.nn.Embedding(num_users, 1,
                                             sparse_grad=sparse_grad)
            self.item_b = gluon.nn.Embedding(num_items, 1,
                                             sparse_grad=sparse_grad)

    def hybrid_forward(self, F, users, items):
        p = self.user(users)
        q = self.item(items)
        return ((p * q).sum(axis=1)
                + self.user_b(users).reshape((-1,))
                + self.item_b(items).reshape((-1,)))


def synthetic_ratings(rng, num_users, num_items, rank, n):
    u_true = rng.randn(num_users, rank) * 0.7
    i_true = rng.randn(num_items, rank) * 0.7
    users = rng.randint(0, num_users, n)
    items = rng.randint(0, num_items, n)
    ratings = (u_true[users] * i_true[items]).sum(1) + 3.0 \
        + 0.1 * rng.randn(n)
    return (users.astype(np.float32), items.astype(np.float32),
            ratings.astype(np.float32))


def train(args, ctx):
    """Train MFNet as the flags say, on `ctx`; returns the validation
    RMSE after each epoch."""
    mx.random.seed(args.seed)
    rng = np.random.RandomState(args.seed)
    users, items, ratings = synthetic_ratings(
        rng, args.num_users, args.num_items, args.rank, args.samples)
    n_train = int(args.samples * 0.9)

    net = MFNet(args.num_users, args.num_items, args.rank)
    net.initialize(mx.init.Normal(0.1), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), args.optimizer,
                            {"learning_rate": args.lr})
    loss_fn = gluon.loss.L2Loss()
    bs = args.batch_size

    def rmse(lo, hi):
        pred = net(mx.nd.array(users[lo:hi], ctx=ctx),
                   mx.nd.array(items[lo:hi], ctx=ctx)).asnumpy()
        return float(np.sqrt(np.mean((pred - ratings[lo:hi]) ** 2)))

    vals = []
    for epoch in range(args.epochs):
        perm = rng.permutation(n_train)
        total = 0.0
        for off in range(0, n_train - bs + 1, bs):
            sel = perm[off:off + bs]
            u = mx.nd.array(users[sel], ctx=ctx)
            i = mx.nd.array(items[sel], ctx=ctx)
            r = mx.nd.array(ratings[sel], ctx=ctx)
            with autograd.record():
                loss = loss_fn(net(u, i), r).sum()
            loss.backward()
            # row-sparse gradients: only this batch's embedding rows move
            trainer.step(bs)
            total += float(loss.asnumpy())
        vals.append(rmse(n_train, args.samples))
        logging.info("epoch %d  train_loss %.4f  val_rmse %.4f", epoch,
                     total / n_train, vals[-1])
    return vals


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="matrix factorization")
    ap.add_argument("--num-users", type=int, default=200)
    ap.add_argument("--num-items", type=int, default=150)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--optimizer", default="adam",
                    help="adam/sgd: both take the lazy sparse path")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    vals = train(args, mx.cpu() if args.device == "cpu" else mx.gpu(0))
    logging.info("val RMSE %.4f -> %.4f", vals[0], vals[-1])
    if not vals[-1] < vals[0]:
        raise SystemExit("matrix factorization failed to improve RMSE")
    return vals


if __name__ == "__main__":
    main(sys.argv[1:])
