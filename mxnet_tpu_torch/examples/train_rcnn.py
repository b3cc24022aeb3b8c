"""Mini Faster R-CNN: RPN training, Proposal, and a ROIPooling head, on
the port.

Counterpart of ``examples/train_rcnn.py`` (reference: example/rcnn,
train_end2end.py), which wires the detection ops end to end on
synthetic data:

1. a small conv backbone over the image,
2. an RPN head trained with (a) objectness cross-entropy against anchor
   labels and (b) smooth-L1 on bbox regression targets,
3. the non-differentiable ``Proposal`` op (greedy NMS on the card's D1
   kernel) turning RPN outputs into ROIs,
4. ``ROIPooling`` (the card's D2 forward kernel only: it runs outside
   ``autograd.record``, as in the JAX example, so D2's backward is not
   reached) and a classifier head trained on the proposals' overlap
   with ground truth.

Synthetic scenes: one bright square object per image; the GT box is
where the square is::

    python -m mxnet_tpu_torch.examples.train_rcnn --steps 20

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

IMG = 32          # image size
FEAT = 8          # backbone stride 4 -> 8x8 feature map
STRIDE = IMG // FEAT
ANCHOR = 12.0     # single square anchor per cell


def synthetic_scene(rng):
    """One bright 10-14px square on a noisy background; returns
    (image CHW, gt box [x1, y1, x2, y2])."""
    img = rng.rand(3, IMG, IMG).astype(np.float32) * 0.2
    size = rng.randint(10, 15)
    x1 = rng.randint(0, IMG - size)
    y1 = rng.randint(0, IMG - size)
    img[:, y1:y1 + size, x1:x1 + size] += 0.8
    return img, np.array([x1, y1, x1 + size, y1 + size], np.float32)


def anchor_grid():
    """(FEAT*FEAT, 4) anchor boxes, one centered per feature cell."""
    cy, cx = np.mgrid[0:FEAT, 0:FEAT].astype(np.float32)
    cx = (cx.ravel() + 0.5) * STRIDE
    cy = (cy.ravel() + 0.5) * STRIDE
    half = ANCHOR / 2
    return np.stack([cx - half, cy - half, cx + half, cy + half], 1)


def iou(anchors, box):
    ix1 = np.maximum(anchors[:, 0], box[0])
    iy1 = np.maximum(anchors[:, 1], box[1])
    ix2 = np.minimum(anchors[:, 2], box[2])
    iy2 = np.minimum(anchors[:, 3], box[3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    a_area = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    b_area = (box[2] - box[0]) * (box[3] - box[1])
    return inter / (a_area + b_area - inter + 1e-9)


def rpn_targets(anchors, gt):
    """Objectness labels (IoU>0.5 -> 1, <0.2 -> 0, else ignore=-1) and
    bbox-regression targets for positives (the reference's anchor
    assignment, rcnn/rpn style)."""
    ious = iou(anchors, gt)
    labels = np.full(len(anchors), -1.0, np.float32)
    labels[ious < 0.2] = 0.0
    labels[ious > 0.5] = 1.0
    if labels.max() < 1.0:      # guarantee one positive
        labels[np.argmax(ious)] = 1.0
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    gw, gh = gt[2] - gt[0], gt[3] - gt[1]
    gcx, gcy = gt[0] + gw / 2, gt[1] + gh / 2
    t = np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                  np.log(gw / aw), np.log(gh / ah)], 1).astype(np.float32)
    return labels, t


class RCNN(gluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.c1 = gluon.nn.Conv2D(16, 3, strides=2, padding=1)
            self.c2 = gluon.nn.Conv2D(32, 3, strides=2, padding=1)
            self.rpn_conv = gluon.nn.Conv2D(32, 3, padding=1)
            self.rpn_cls = gluon.nn.Conv2D(2, 1)    # bg/fg per anchor
            self.rpn_bbox = gluon.nn.Conv2D(4, 1)

    def hybrid_forward(self, F, x):
        feat = F.relu(self.c2(F.relu(self.c1(x))))
        rpn = F.relu(self.rpn_conv(feat))
        return feat, self.rpn_cls(rpn), self.rpn_bbox(rpn)


def run(steps=30, batch_size=4, lr=0.01, seed=3, ctx=None):
    """Train; returns the per-step RPN losses."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)

    net = RCNN()
    head = gluon.nn.HybridSequential()   # ROI classifier: object vs bg
    head.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(2))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    head.initialize(mx.init.Xavier(), ctx=ctx)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": lr, "momentum": 0.9})
    tr_head = gluon.Trainer(head.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    anchors = anchor_grid()
    bs = batch_size

    losses = []
    for step in range(steps):
        imgs, labels, targets, gts = [], [], [], []
        for _ in range(bs):
            img, gt = synthetic_scene(rng)
            lab, tgt = rpn_targets(anchors, gt)
            imgs.append(img)
            labels.append(lab)
            targets.append(tgt)
            gts.append(gt)
        x = mx.nd.array(np.stack(imgs), ctx=ctx)
        lab = mx.nd.array(np.stack(labels), ctx=ctx)     # (B, A)
        tgt = mx.nd.array(np.stack(targets), ctx=ctx)    # (B, A, 4)

        with autograd.record():
            _, cls, bbox = net(x)
            # (B, 2, H, W) -> (B, A, 2); (B, 4, H, W) -> (B, A, 4)
            cls_r = cls.reshape((bs, 2, -1)).transpose((0, 2, 1))
            bbox_r = bbox.reshape((bs, 4, -1)).transpose((0, 2, 1))
            cls_loss = ce(cls_r.reshape((-1, 2)), lab.reshape((-1,)),
                          (lab.reshape((-1, 1)) >= 0))
            pos = (lab == 1.0).reshape((bs, -1, 1))
            box_loss = mx.nd.smooth_l1((bbox_r - tgt) * pos,
                                       scalar=3.0).sum()
            loss = cls_loss.sum() + box_loss
        loss.backward()
        tr.step(bs)

        # Proposal op (non-differentiable) -> ROIs -> pooled head.
        feat, cls, bbox = net(x)
        prob = mx.nd.softmax(cls.reshape((bs, 2, -1)), axis=1) \
            .reshape(cls.shape)
        im_info = mx.nd.array(np.tile([IMG, IMG, 1.0], (bs, 1)), ctx=ctx)
        rois = mx.nd._contrib_Proposal(
            prob, bbox, im_info, feature_stride=STRIDE,
            scales=(ANCHOR / STRIDE,), ratios=(1.0,),
            rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8,
            threshold=0.7, rpn_min_size=4)
        pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(4, 4),
                                  spatial_scale=1.0 / STRIDE)
        # label each ROI by IoU with its image's GT box
        roi_np = rois.asnumpy()
        roi_lab = np.zeros(len(roi_np), np.float32)
        for i, r in enumerate(roi_np):
            b = int(r[0])
            roi_lab[i] = 1.0 if iou(r[None, 1:], gts[b])[0] > 0.5 else 0.0
        with autograd.record():
            head_loss = ce(head(pooled), mx.nd.array(roi_lab, ctx=ctx)).sum()
        head_loss.backward()
        tr_head.step(len(roi_np))

        cur = float(loss.asnumpy()) / bs
        losses.append(cur)
        if step % 10 == 0 or step == steps - 1:
            logging.info("step %d  rpn_loss %.4f  head_loss %.4f  "
                         "rois %d", step, cur,
                         float(head_loss.asnumpy()) / len(roi_np),
                         len(roi_np))
    logging.info("rpn loss %.4f -> %.4f", losses[0], losses[-1])
    if not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
        raise SystemExit("rcnn RPN loss did not improve")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    run(args.steps, args.batch_size, args.lr, args.seed,
        mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main()
