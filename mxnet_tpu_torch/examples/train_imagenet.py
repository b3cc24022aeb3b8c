"""Train an ImageNet-class CNN: the reference's headline driver, on the
port.

Counterpart of ``examples/train_imagenet.py:30-91`` (reference:
example/image-classification/train_imagenet.py + common/fit.py). The hot
path is :class:`mxnet_tpu_torch.parallel.TrainStep`: forward, softmax
cross-entropy, backward and SGD with momentum and weight decay as one
step. ``--benchmark 1`` feeds synthetic data and prints img/s with the
reference's protocol: one step to materialize, 3 warmup steps, then
windows of 16 iterations at batch 32 (10 above), each closed by a host
readback of the loss, and the median over the windows::

    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1
    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \\
        --dtype bfloat16

``--data-train x.rec`` trains from a RecordIO file instead, as
``examples/train_imagenet.py:139-165`` does: ``mx.io.ImageRecordIter``
(random crop and mirror, shuffled through the ``.idx`` beside the file
when there is one) feeds its batches, copied to the card through pinned
memory on a side stream, into the same step, for ``--num-epochs``
epochs of at most ``--max-batches`` batches::

    python -m mxnet_tpu_torch.examples.train_imagenet --data-train x.rec \\
        --max-batches 50

``--kv-store dist_sync`` (or ``dist_device_sync``/``dist_async``)
trains through ``gluon.Trainer`` over the parameter-server store
instead: each worker of a job started with ``parallel.launch -n N -s
S`` trains on its own synthetic batch of ``--batch-size`` and the
servers run SGD on the summed gradients (``--benchmark 1`` prints the
worker's img/s)::

    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 1 \
        python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --kv-store dist_sync

It runs on ``gpu(0)`` unless ``--device cpu`` is given. Every network
of the reference's factory is served (``_NETWORKS``); Inception-v3 takes
``--image-shape 3,299,299``::

    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --network inception-v3 --image-shape 3,299,299
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

_NETWORKS = ("resnet18", "resnet34", "resnet50", "resnet101", "alexnet",
             "vgg16", "inception-v3", "mobilenet")


def build_net(network, num_classes, ctx=None):
    """The network, initialized (deferred shapes) on `ctx`."""
    from ..gluon.model_zoo import vision

    factory = {
        "resnet18": vision.resnet18_v1, "resnet34": vision.resnet34_v1,
        "resnet50": vision.resnet50_v1, "resnet101": vision.resnet101_v1,
        "alexnet": vision.alexnet, "vgg16": vision.vgg16,
        "inception-v3": vision.inception_v3,
        "mobilenet": vision.mobilenet1_0,
    }[network]
    net = factory(classes=num_classes)
    net.initialize(ctx=ctx)
    return net


def build_train_step(network="resnet50", num_classes=1000, dtype=None,
                     device=None, lr=0.1, momentum=0.9, wd=1e-4):
    """The training step the benchmark measures: SGD with momentum and
    weight decay over softmax cross-entropy, on `device` (a Context,
    default ``gpu(0)``)."""
    from .. import gluon
    from ..context import gpu
    from ..parallel import TrainStep, make_mesh

    device = device if device is not None else gpu(0)
    net = build_net(network, num_classes, ctx=device)
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd",
                     optimizer_params={"learning_rate": lr,
                                       "momentum": momentum, "wd": wd},
                     mesh=make_mesh({"dp": 1}, devices=[device]),
                     dtype=dtype)


def benchmark_rate(network="resnet50", batch=32, dtype=None, device=None,
                   image_shape=(3, 224, 224), iters=None, windows=5,
                   warmup=3, num_classes=1000, lr=0.1, momentum=0.9,
                   wd=1e-4):
    """img/s, median over `windows`; each window of `iters` steps
    (default 16 at batch <= 32, else 10, as bench.py runs it) is closed
    by a host readback of the loss."""
    import torch

    if iters is None:
        iters = 16 if batch <= 32 else 10
    step = build_train_step(network, num_classes, dtype, device, lr=lr,
                            momentum=momentum, wd=wd)
    rng = np.random.RandomState(0)
    x = rng.rand(batch, *image_shape).astype(np.float32)
    y = rng.randint(0, num_classes, batch).astype(np.float32)
    step(x, y)  # materialize
    x = torch.from_numpy(x).to(step._data_sharding)
    y = torch.from_numpy(y).to(step._data_sharding)
    loss = None
    for _ in range(warmup):
        loss = step(x, y)
    if loss is not None:
        float(loss)  # drain the warmup chain
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step(x, y)
        float(loss)  # completion proof
        rates.append(batch * iters / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def trainer_rate(network="resnet50", batch=32, kvstore="dist_sync",
                 device=None, image_shape=(3, 224, 224), iters=None,
                 windows=5, warmup=2, num_classes=1000, lr=0.1,
                 momentum=0.9, wd=1e-4):
    """img/s of this worker through ``gluon.Trainer`` over `kvstore`,
    on the windows of :func:`benchmark_rate`. ``trainer.step`` takes
    the global batch (every worker's), so the server's SGD update is
    that of the mean over the global batch."""
    import torch

    from .. import autograd, gluon
    from .. import kvstore as kvs
    from ..context import gpu

    device = device if device is not None else gpu(0)
    if iters is None:
        iters = 16 if batch <= 32 else 10
    kv = kvs.create(kvstore) if isinstance(kvstore, str) else kvstore
    net = build_net(network, num_classes, ctx=device)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(kv.rank)
    with device:
        x = gluon.utils.split_and_load(
            rng.rand(batch, *image_shape).astype(np.float32), [device])[0]
        y = gluon.utils.split_and_load(
            rng.randint(0, num_classes, batch).astype(np.float32),
            [device])[0]
    with autograd.pause():
        net(x)      # materialize the deferred shapes
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": momentum,
                             "wd": wd}, kvstore=kv)

    def one():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch * kv.num_workers)
        return loss

    for _ in range(warmup):
        one()
    torch.cuda.synchronize() if device.device_type == "gpu" else None
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = one()
        float(loss.mean().asnumpy())  # completion proof
        rates.append(batch * iters / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def train_from_rec(step, data_train, batch_size, image_shape, num_epochs=1,
                   max_batches=0, ctx=None):
    """Train `step` on the records of `data_train` through
    ``mx.io.ImageRecordIter``; returns the last loss as a float."""
    from .. import io as mxio

    idx_path = os.path.splitext(data_train)[0] + ".idx"
    if not os.path.exists(idx_path):
        logging.warning("no %s: shuffle is a no-op without the index",
                        idx_path)
    it = mxio.ImageRecordIter(
        path_imgrec=data_train,
        path_imgidx=idx_path if os.path.exists(idx_path) else None,
        batch_size=batch_size, data_shape=image_shape, shuffle=True,
        rand_crop=True, rand_mirror=True, ctx=ctx)
    loss = None
    try:
        for epoch in range(num_epochs):
            it.reset()
            t0 = time.perf_counter()
            n = 0
            for i, batch in enumerate(it):
                loss = step(batch.data[0], batch.label[0])
                n += batch_size
                if max_batches and i + 1 >= max_batches:
                    break
            if loss is None:
                raise SystemExit("no batches in %s (batch size %d too "
                                 "large?)" % (data_train, batch_size))
            logging.info("epoch %d: loss %.4f, %.1f img/s", epoch,
                         float(loss), n / (time.perf_counter() - t0))
    finally:
        it.close()
    step.sync_to_net()
    return float(loss)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet (from a .rec, or the synthetic-data "
        "benchmark)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--network", default="resnet50", choices=_NETWORKS)
    parser.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--mom", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--benchmark", type=int, default=0,
                        help="1: synthetic data, print img/s (the "
                        "reference's measurement mode)")
    parser.add_argument("--data-train", default=None,
                        help=".rec file for real training data")
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--max-batches", type=int, default=0,
                        help="stop an epoch early (0 = full epoch); with "
                        "--benchmark, the batches of each timed window "
                        "(0 = 16 at batch <= 32, else 10)")
    parser.add_argument("--kv-store", default="device",
                        help="dist_sync/dist_device_sync/dist_async: train "
                        "through gluon.Trainer over the parameter servers")
    args = parser.parse_args(argv)
    from ..context import cpu, gpu

    device = cpu() if args.device == "cpu" else gpu(0)
    shape = tuple(int(v) for v in args.image_shape.split(","))
    dtype = None if args.dtype == "float32" else args.dtype
    if "dist" in args.kv_store:
        if not args.benchmark:
            raise SystemExit("--kv-store %s trains the synthetic benchmark: "
                             "add --benchmark 1" % args.kv_store)
        if dtype is not None:
            raise SystemExit("--kv-store %s trains in float32"
                             % args.kv_store)
        rate = trainer_rate(args.network, args.batch_size, args.kv_store,
                            device=device, image_shape=shape,
                            iters=args.max_batches or None,
                            num_classes=args.num_classes, lr=args.lr,
                            momentum=args.mom, wd=args.wd)
        print("benchmark: %s b%d float32 %s on %s: %.2f img/s (this worker)"
              % (args.network, args.batch_size, args.kv_store, device, rate))
        return rate
    if not args.benchmark:
        if not args.data_train:
            raise SystemExit("provide --data-train <file.rec> or "
                             "--benchmark 1")
        logging.basicConfig(level=logging.INFO)
        step = build_train_step(args.network, args.num_classes, dtype,
                                device, lr=args.lr, momentum=args.mom,
                                wd=args.wd)
        loss = train_from_rec(step, args.data_train, args.batch_size, shape,
                              args.num_epochs, args.max_batches, ctx=device)
        print("trained: %s b%d %s on %s: final loss %.4f"
              % (args.network, args.batch_size, args.dtype, device, loss))
        return loss
    rate = benchmark_rate(args.network, args.batch_size, dtype,
                          device=device, image_shape=shape,
                          iters=args.max_batches or None,
                          num_classes=args.num_classes, lr=args.lr,
                          momentum=args.mom, wd=args.wd)
    print("benchmark: %s b%d %s on %s: %.2f img/s"
          % (args.network, args.batch_size, args.dtype, device, rate))
    return rate


if __name__ == "__main__":
    main(sys.argv[1:])
