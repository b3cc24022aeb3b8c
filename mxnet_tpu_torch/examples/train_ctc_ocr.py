"""CTC sequence recognition: read digit strings off synthetic strips
without per-frame alignment, on the port.

Counterpart of ``examples/train_ctc_ocr.py`` (reference: example/ctc and
example/captcha): ``gluon.loss.CTCLoss`` (the ``ctc_loss`` operator)
over unaligned (strip, label string) pairs, a convolutional column
encoder with a GRU head, and greedy CTC decoding (collapse repeats, drop
blanks) for evaluation. Each 12x48 strip, made from the seed, holds 2-3
blocky glyphs of 4 classes at random positions. At a short run the model
is still in CTC's all-blank phase (the loss falls, decodes are empty);
the loss trajectory is the criterion::

    python -m mxnet_tpu_torch.examples.train_ctc_ocr --steps 40

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

H, W = 12, 48          # strip size
MAXLEN = 3             # most digits per strip
VOC = 4                # digit classes; the CTC blank is class VOC
MINLEN = 2

# 5x7 blocky digit glyphs (rows of 5 bits per digit).
_GLYPHS = [
    0x1F11111F, 0x04040404, 0x1F101F01, 0x1F101F10, 0x11111F10,
    0x1F011F10, 0x1F011F11, 0x1F101010, 0x1F111F11, 0x1F111F10,
]


def _glyph(d):
    bits = _GLYPHS[d]
    g = np.zeros((7, 5), np.float32)
    for r in range(7):
        row = (bits >> (5 * (r % 6))) & 0x1F
        for c in range(5):
            g[r, c] = (row >> (4 - c)) & 1
    return g


GLYPHS = [_glyph(d) for d in range(10)]


def make_strip(rng):
    n = rng.randint(MINLEN, MAXLEN + 1)
    digits = rng.randint(0, VOC, n)
    img = rng.rand(H, W).astype(np.float32) * 0.15
    xs = np.sort(rng.choice(np.arange(2, W - 7, 6), n, replace=False))
    for d, x in zip(digits, xs):
        y = rng.randint(1, H - 8)
        img[y:y + 7, x:x + 5] += GLYPHS[d] * 0.8
    label = np.full(MAXLEN, -1, np.float32)
    label[:n] = digits
    return img, label


class OCRNet(gluon.HybridBlock):
    """Column encoder: a conv over the strip, then per-column features
    feed a GRU whose per-step outputs are the CTC frame activations."""

    def __init__(self, hidden=48, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.conv = gluon.nn.Conv2D(12, 3, padding=1,
                                        activation="relu")
            self.pool = gluon.nn.MaxPool2D((2, 2))   # (H/2, W/2)
            self.gru = gluon.rnn.GRU(hidden, layout="NTC")
            self.head = gluon.nn.Dense(VOC + 1, flatten=False)

    def hybrid_forward(self, F, x):
        f = self.pool(self.conv(x))                  # (N, C, H/2, W/2)
        f = f.transpose((0, 3, 1, 2))                # (N, T=W/2, C, H/2)
        f = f.reshape((0, 0, -1))                    # (N, T, C*H/2)
        return self.head(self.gru(f))                # (N, T, VOC+1)


def greedy_decode(frames):
    """Collapse repeats, then drop blanks (CTC's best path)."""
    best = frames.argmax(axis=-1)
    out = []
    for row in best:
        prev = -1
        s = []
        for t in row:
            if t != prev and t != VOC:
                s.append(int(t))
            prev = t
        out.append(s)
    return out


def run(steps=150, batch_size=32, lr=1e-3, seed=1, ctx=None):
    """Train; returns {"ctc_loss": [per step], "exact": share of fresh
    strips decoded exactly}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    bs = batch_size

    def batch():
        imgs, labels = zip(*(make_strip(rng) for _ in range(bs)))
        return (mx.nd.array(np.stack(imgs)[:, None]),
                mx.nd.array(np.stack(labels)))

    losses = []
    with ctx:
        net = OCRNet()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr, "clip_gradient": 5.0})
        # NTC is the head's (N, T, C) layout; the blank is the last class.
        ctc = gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
        for step in range(steps):
            x, y = batch()
            with autograd.record():
                loss = ctc(net(x), y).sum()
            loss.backward()
            tr.step(bs)
            losses.append(float(loss.asnumpy()) / bs)
            if step % 25 == 0 or step == steps - 1:
                print("step %d  ctc_loss %.3f" % (step, losses[-1]),
                      flush=True)
        # Greedy exact-sequence match on fresh strips (0.00 at a short
        # run: see the module docstring).
        x, y = batch()
        with autograd.pause():
            decoded = greedy_decode(net(x).asnumpy())
    truth = [[int(v) for v in row if v >= 0] for row in y.asnumpy()]
    exact = float(np.mean([d == t for d, t in zip(decoded, truth)]))
    first, last = losses[0], losses[-1]
    print("ctc loss %.3f -> %.3f   exact-sequence %.2f"
          % (first, last, exact), flush=True)
    print("sample: truth=%s decoded=%s" % (truth[0], decoded[0]),
          flush=True)
    if not (np.isfinite(last) and last < first * 0.9):
        raise SystemExit("CTC training did not reduce loss")
    return {"ctc_loss": losses, "exact": exact}


def main(argv=None):
    ap = argparse.ArgumentParser(description="CTC OCR on synthetic strips")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.steps, args.batch_size, args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
