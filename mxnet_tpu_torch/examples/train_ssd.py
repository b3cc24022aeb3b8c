"""SSD detection training, on the port.

Counterpart of ``examples/train_ssd.py`` (reference example/ssd/
train.py; BASELINE.md's SSD-VGG16 multi-host ``dist_sync`` config, here
with a small trunk): a conv trunk with one class head and one box head
per scale, ``MultiBoxPrior`` anchors, ``MultiBoxTarget`` assignment,
softmax cross-entropy + smooth-L1 losses, and ``MultiBoxDetection``
(greedy NMS on the card's D1 kernel) to decode a held-out batch. Data
are generated box-on-noise scenes (``--synthetic``, always on)::

    python -m mxnet_tpu_torch.examples.train_ssd --num-examples 128 \\
        --num-epochs 8 --batch-size 16

It runs on ``gpu(0)`` unless ``--device cpu`` is given; with
``--kv-store dist_sync`` under the port's launcher each worker trains
its share of the scenes against the parameter server::

    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 1 python -m \\
        mxnet_tpu_torch.examples.train_ssd --kv-store dist_sync

Rank 0 prints ``final-loss <loss> recall <held-out recall@0.3>``.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


class SSDNet(gluon.HybridBlock):
    """Conv trunk + one detection head per scale (reference example/ssd
    symbol/symbol_builder.py structure, reduced)."""

    def __init__(self, num_classes=1, filters=(32, 64), num_anchors=3):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.stages = []
        self.cls_heads = []
        self.loc_heads = []
        for i, f in enumerate(filters):
            stage = gluon.nn.HybridSequential()
            stage.add(gluon.nn.Conv2D(f, 3, padding=1, activation="relu"),
                      gluon.nn.Conv2D(f, 3, padding=1, activation="relu"),
                      gluon.nn.MaxPool2D(2))
            self.register_child(stage, "stage%d" % i)
            self.stages.append(stage)
            cls = gluon.nn.Conv2D(num_anchors * (num_classes + 1), 3,
                                  padding=1)
            loc = gluon.nn.Conv2D(num_anchors * 4, 3, padding=1)
            self.register_child(cls, "cls%d" % i)
            self.register_child(loc, "loc%d" % i)
            self.cls_heads.append(cls)
            self.loc_heads.append(loc)

    def hybrid_forward(self, F, x):
        anchors, cls_preds, loc_preds = [], [], []
        sizes = [(0.25, 0.35), (0.55, 0.75)]
        for stage, cls_h, loc_h, sz in zip(self.stages, self.cls_heads,
                                           self.loc_heads, sizes):
            x = stage(x)
            b = x.shape[0]
            c = cls_h(x).transpose((0, 2, 3, 1)).reshape(
                (b, -1, self.num_classes + 1))
            l = loc_h(x).transpose((0, 2, 3, 1)).reshape((b, -1))
            anchors.append(F.contrib.MultiBoxPrior(
                x, sizes=sz, ratios=(1.0, 2.0)))
            cls_preds.append(c)
            loc_preds.append(l)
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                F.concat(*loc_preds, dim=1))


def synthetic_scenes(n, size, rng):
    """Bright squares on noise; label rows (cls, x1, y1, x2, y2)."""
    X = (rng.rand(n, 1, size, size) * 0.2).astype(np.float32)
    Y = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        s = rng.randint(size // 3, size // 2 + 1)
        r = rng.randint(0, size - s)
        c = rng.randint(0, size - s)
        X[i, 0, r:r + s, c:c + s] += 1.0
        Y[i, 0] = [0, c / size, r / size, (c + s) / size, (r + s) / size]
    return X, Y


def ssd_loss(cls_preds, loc_preds, box_t, box_m, cls_t, ce):
    """Softmax cross-entropy over anchors + smooth-L1 (sigma 1) over the
    matched boxes' offsets, each a mean."""
    cls_loss = ce(cls_preds.reshape((-1, cls_preds.shape[-1])),
                  cls_t.reshape((-1,))).mean()
    diff = (loc_preds - box_t) * box_m
    adiff = diff.abs()
    loc_loss = mx.nd.where(adiff > 1.0, adiff - 0.5,
                           0.5 * adiff * adiff).mean()
    return cls_loss + loc_loss


def recall_at(det, gts, thresh=0.3):
    """Share of images whose best-scoring detection overlaps the ground
    truth box by IoU above `thresh`."""
    hits = 0
    for rows, gt in zip(det, gts):
        rows = rows[rows[:, 0] >= 0]
        if not len(rows):
            continue
        best = rows[np.argmax(rows[:, 1])]
        x1, y1 = np.maximum(best[2:4], gt[:2])
        x2, y2 = np.minimum(best[4:6], gt[2:])
        inter = max(x2 - x1, 0) * max(y2 - y1, 0)
        union = ((best[4] - best[2]) * (best[5] - best[3])
                 + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
        if inter / max(union, 1e-8) > thresh:
            hits += 1
    return hits / len(gts)


def train(args, ctx=None):
    """Train; returns {"first", "last" (losses), "recall", "net"}."""
    ctx = ctx if ctx is not None else (
        mx.cpu() if args.device == "cpu" else mx.gpu(0))
    kv = mx.kv.create(args.kv_store)
    rank = getattr(kv, "rank", 0)
    num_workers = getattr(kv, "num_workers", 1)
    rng = np.random.RandomState(100 + rank)        # per-worker shard
    n = args.num_examples // num_workers
    X, Y = synthetic_scenes(n, args.data_shape, rng)

    net = SSDNet(num_classes=1, num_anchors=3)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), args.optimizer,
                            {"learning_rate": args.lr, "wd": args.wd},
                            kvstore=kv)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    b = args.batch_size
    first = last = None
    t0 = time.perf_counter()
    seen = 0
    for epoch in range(args.num_epochs):
        perm = rng.permutation(n)
        for start in range(0, n - b + 1, b):
            idx = perm[start:start + b]
            x = mx.nd.array(X[idx], ctx=ctx)
            y = mx.nd.array(Y[idx], ctx=ctx)
            with autograd.record():
                anchors, cls_preds, loc_preds = net(x)
                with autograd.pause():
                    box_t, box_m, cls_t = mx.nd.contrib.MultiBoxTarget(
                        anchors, y, cls_preds.transpose((0, 2, 1)),
                        overlap_threshold=0.5)
                loss = ssd_loss(cls_preds, loc_preds, box_t, box_m, cls_t,
                                ce)
            loss.backward()
            # loss is already a batch MEAN: step(1) keeps rescale at 1
            # (step(b) would divide the gradients by b a second time)
            trainer.step(1)
            seen += b
            last = float(loss.asnumpy().ravel()[0])
            if first is None:
                first = last
        logging.info("epoch %d rank %d: loss %.4f (%.1f img/s)", epoch,
                     rank, last, seen / (time.perf_counter() - t0))
    assert last < first, "loss did not drop: %.4f -> %.4f" % (first, last)

    # eval: decoded detections vs ground truth on a held-out batch
    Xv, Yv = synthetic_scenes(max(b, 16), args.data_shape,
                              np.random.RandomState(999))
    anchors, cls_preds, loc_preds = net(mx.nd.array(Xv, ctx=ctx))
    cls_prob = cls_preds.softmax(axis=-1).transpose((0, 2, 1))
    det = mx.nd.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=0.45,
        threshold=0.01).asnumpy()
    recall = recall_at(det, Yv[:, 0, 1:])
    logging.info("rank %d held-out recall@0.3: %.3f", rank, recall)
    if rank == 0:
        print("final-loss %.4f recall %.4f" % (last, recall), flush=True)
    if hasattr(kv, "close"):
        kv.close()
    return {"first": first, "last": last, "recall": recall, "net": net}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train SSD (reference example/ssd/train.py)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epochs", type=int, default=12)
    parser.add_argument("--num-examples", type=int, default=512)
    parser.add_argument("--data-shape", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.005)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--optimizer", default="adam")
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--synthetic", action="store_true",
                        help="(default) generated scenes")
    parser.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return train(args)


if __name__ == "__main__":
    main()
