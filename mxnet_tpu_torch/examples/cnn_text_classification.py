"""CNN text classification (Kim 2014), on the port.

Counterpart of ``examples/cnn_text_classification.py`` (reference:
example/cnn_text_classification): ``Conv1D`` filters of several widths
over embedded tokens (NCW), max over time per filter bank,
concatenation, dropout and a softmax head. In the synthetic language,
made from the seed, class 0 sentences hold a "positive" bigram and class
1 sentences a "negative" one::

    python -m mxnet_tpu_torch.examples.cnn_text_classification --epochs 4

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

SEQ = 16
VOCAB = 40
POS_BIGRAMS = [(3, 7), (11, 5), (20, 21)]
NEG_BIGRAMS = [(4, 9), (15, 2), (22, 30)]


class KimCNN(gluon.HybridBlock):
    def __init__(self, widths=(2, 3, 4), filters=16, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.embed = gluon.nn.Embedding(VOCAB, 24)
            self.convs = gluon.nn.HybridSequential()
            for w in widths:
                self.convs.add(gluon.nn.Conv1D(filters, w,
                                               activation="relu"))
            self.drop = gluon.nn.Dropout(0.3)
            self.out = gluon.nn.Dense(2)

    def hybrid_forward(self, F, tokens):
        e = self.embed(tokens).transpose((0, 2, 1))   # (N, emb, T) NCW
        pooled = [c(e).max(axis=2) for c in self.convs]
        return self.out(self.drop(F.concat(*pooled, dim=1)))


def make_data(rng, n):
    toks = rng.randint(0, VOCAB, (n, SEQ))
    labels = rng.randint(0, 2, n)
    for i, lab in enumerate(labels):
        a, b = (POS_BIGRAMS if lab == 0 else NEG_BIGRAMS)[rng.randint(3)]
        pos = rng.randint(0, SEQ - 1)
        toks[i, pos], toks[i, pos + 1] = a, b
    return toks.astype(np.float32), labels.astype(np.float32)


def run(epochs=5, train=2048, batch_size=64, lr=2e-3, seed=8, ctx=None):
    """Train; returns {"loss": [per epoch], "val_acc": [per epoch]}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    X, Y = make_data(rng, train)
    Xv, Yv = make_data(rng, 512)
    history = {"loss": [], "val_acc": []}
    with ctx:
        net = KimCNN()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
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
                acc = float((net(mx.nd.array(Xv)).asnumpy().argmax(1)
                             == Yv).mean())
            history["loss"].append(tot / n_seen)
            history["val_acc"].append(acc)
            print("epoch %d  loss %.4f  val-acc %.3f"
                  % (epoch, history["loss"][-1], acc), flush=True)
    if history["val_acc"][-1] < 0.85:
        raise SystemExit("text CNN failed to find the bigram patterns "
                         "(val-acc %.3f)" % history["val_acc"][-1])
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description="CNN text classification")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--train", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.epochs, args.train, args.batch_size, args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
