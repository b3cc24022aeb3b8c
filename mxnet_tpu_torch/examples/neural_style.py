"""Neural style transfer: optimize an image against conv features, on
the port.

Counterpart of ``examples/neural_style.py`` (reference:
example/neural-style, after Gatys et al.): the trainable object is the
input image itself, driven by a content loss (a feature match at a deep
stage) and a style loss (Gram matrices matched at every stage), through
``attach_grad`` on a plain NDArray and the ``sgd_mom_update`` operator.
With no pretrained VGG weights, the feature net is a small conv stack
initialized from the seed; the content and style images are synthetic::

    python -m mxnet_tpu_torch.examples.neural_style --steps 60

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

SIZE = 32


def feature_net(ctx):
    """Conv stack; the features are tapped after each stage."""
    stages = []
    for ch in (8, 16, 32):
        s = gluon.nn.HybridSequential()
        s.add(gluon.nn.Conv2D(ch, 3, padding=1, activation="relu"),
              gluon.nn.Conv2D(ch, 3, padding=1, activation="relu"),
              gluon.nn.AvgPool2D(2))
        stages.append(s)
    net = gluon.nn.HybridSequential()
    for s in stages:
        net.add(s)
    net.initialize(mx.init.Xavier(magnitude=2.5), ctx=ctx)
    return stages


def features(stages, x):
    outs = []
    h = x
    for s in stages:
        h = s(h)
        outs.append(h)
    return outs


def gram(f):
    """(N, C, H, W) -> (N, C, C) normalized Gram matrix."""
    n, c = f.shape[0], f.shape[1]
    flat = f.reshape((n, c, -1))
    return mx.nd.batch_dot(flat, flat.transpose((0, 2, 1))) / \
        float(flat.shape[2])


def content_image():
    """A ring on a gradient background."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    img = np.stack([xx / SIZE, yy / SIZE, (xx + yy) / (2 * SIZE)])
    r = np.sqrt((yy - SIZE / 2) ** 2 + (xx - SIZE / 2) ** 2)
    ring = np.exp(-((r - 9.0) ** 2) / 6.0)
    return (img * 0.5 + ring[None] * 0.5).astype(np.float32)


def style_image():
    """Diagonal stripes."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    stripes = (np.sin((xx + yy) * 0.8) * 0.5 + 0.5).astype(np.float32)
    return np.stack([stripes, 1 - stripes, stripes * 0.5])


def run(steps=120, lr=0.2, style_weight=1.0, seed=0, ctx=None):
    """Optimize the canvas; returns {"loss": [per step]}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    losses = []
    with ctx:
        stages = feature_net(ctx)
        content = mx.nd.array(content_image()[None])
        style = mx.nd.array(style_image()[None])
        with autograd.pause():
            # Per-stage normalization: random relu stacks attenuate
            # ~20x per stage; dividing by the content features' std
            # puts every stage's loss at O(1).
            scales = [float(f.asnumpy().std()) + 1e-8
                      for f in features(stages, content)]

        def norm_features(x):
            return [f / sc for f, sc in zip(features(stages, x), scales)]

        with autograd.pause():
            content_feat = norm_features(content)[-1]
            style_grams = [gram(f) for f in norm_features(style)]
        # The canvas is the trainable variable, from noise so that both
        # losses are live.
        canvas = mx.nd.array(rng.rand(1, 3, SIZE, SIZE).astype(np.float32))
        canvas.attach_grad()
        mom = mx.nd.zeros(canvas.shape)
        for step in range(steps):
            with autograd.record():
                feats = norm_features(canvas)
                c_loss = ((feats[-1] - content_feat) ** 2).mean()
                s_loss = sum(((gram(f) - g) ** 2).mean()
                             for f, g in zip(feats, style_grams))
                loss = c_loss + style_weight * s_loss
            loss.backward()
            mx.nd.sgd_mom_update(canvas, canvas.grad, mom, lr=lr,
                                 momentum=0.9, out=(canvas, mom))
            canvas._set_data(canvas._data.clip(0.0, 1.0))
            losses.append(float(loss.asnumpy()))
            if step % 20 == 0 or step == steps - 1:
                print("step %d  loss %.5f (content %.5f style %.5f)"
                      % (step, losses[-1], float(c_loss.asnumpy()),
                         float(s_loss.asnumpy())), flush=True)
    first, last = losses[0], losses[-1]
    print("total loss %.5f -> %.5f" % (first, last), flush=True)
    if not (np.isfinite(last) and last < first * 0.7):
        raise SystemExit("style optimization did not converge")
    return {"loss": losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description="neural style transfer")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--style-weight", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    return run(args.steps, args.lr, args.style_weight, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
