"""The port's fast training path end to end: RecordIO, the sharded
streaming pipeline, one TrainStep a batch, and a checkpoint.

Counterpart of ``examples/train_resnet_trainstep.py``:

1. a synthetic labelled image set packed into an indexed RecordIO pair
   (PNG, the port's own codec: what ``tools/im2rec.py`` produces);
2. ``mx.data.DataPipeline``: each rank decodes only its equal shard of
   every epoch (``num_shards``/``shard_index`` default from
   ``parallel.dist``), in a decode pool, with double-buffered placement
   on the rank's device;
3. ``parallel.TrainStep`` over ``make_mesh()``: one card, or, launched
   with ``-s 0``, a ``dp`` mesh of ranks (global-batch loss and
   BatchNorm statistics, gradients summed over the group);
4. ``save_checkpoint``, and the pipeline's ``state_dict``.

One process::

    python -m mxnet_tpu_torch.examples.train_resnet_trainstep --steps 30

A group of two ranks (gloo on the host with ``--device cpu``, NCCL
with one card per rank)::

    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 0 \\
        python -m mxnet_tpu_torch.examples.train_resnet_trainstep \\
        --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile
import time

import numpy as np


def pack_dataset(mx, path_prefix, n, size, classes, rng):
    """Synthetic labelled PNGs into an indexed RecordIO pair."""
    from mxnet_tpu_torch import recordio

    rec, idx = path_prefix + ".rec", path_prefix + ".idx"
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        lab = i % classes
        img = (rng.rand(size, size, 3) * 60).astype(np.uint8)
        c = 12 + 8 * lab            # a class-dependent blob: learnable
        img[c:c + 10, c:c + 10] += 150
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(lab), i, 0), img, img_fmt=".png"))
    w.close()
    return rec, idx


def main(argv=None):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="global batch, split evenly over the ranks")
    ap.add_argument("--image-size", type=int, default=56)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype inside the step (masters fp32)")
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--preprocess-threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    # A group when launched with the DMLC_* contract (-s 0); one process
    # falls straight through.
    dist.initialize(platform=args.device)
    ctx = dist.local_context() if dist.is_initialized() else \
        (mx.cpu() if args.device == "cpu" else mx.gpu(0))
    mx.random.seed(args.seed)
    rng = np.random.RandomState(args.seed)
    dtype = None if args.dtype == "float32" else args.dtype
    if args.batch_size % dist.num_processes():
        raise SystemExit("--batch-size %d must divide evenly over %d "
                         "processes" % (args.batch_size,
                                        dist.num_processes()))
    per_rank = args.batch_size // dist.num_processes()

    with tempfile.TemporaryDirectory() as td, ctx:
        rec, idx = pack_dataset(mx, os.path.join(td, "ds"), args.samples,
                                args.image_size, args.classes, rng)
        it = mx.data.DataPipeline(
            mx.data.RecordDataset([rec], [idx]),
            mx.data.ImageRecordDecoder((3, 48, 48), rand_crop=True,
                                       rand_mirror=True,
                                       mean=np.array([30.0, 30.0, 30.0])),
            batch_size=per_rank, shuffle=True, seed=args.seed,
            decode_threads=args.preprocess_threads, prefetch=2,
            place=ctx.device_type == "gpu", ctx=ctx)
        net = vision.resnet18_v1(classes=args.classes, thumbnail=True)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        mesh = make_mesh({"dp": -1}) if dist.is_initialized() else \
            make_mesh({"dp": 1}, devices=[ctx])
        step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                         optimizer="sgd",
                         optimizer_params={"learning_rate": args.lr,
                                           "momentum": 0.9, "wd": 1e-4},
                         mesh=mesh, dtype=dtype)
        losses, seen, t0 = [], 0, None
        for s in range(args.steps):
            batch = next(it)        # epochs advance inside the pipeline
            loss = step(batch.data[0], batch.label[0])
            losses.append(float(loss))
            if s == 0:
                t0 = time.monotonic()   # the first step builds the state
            else:
                seen += args.batch_size
            if s % 10 == 0 or s == args.steps - 1:
                logging.info("rank %d step %d  loss %.4f", dist.rank(), s,
                             losses[-1])
        rate = seen / (time.monotonic() - t0)
        ckpt = step.save_checkpoint(os.path.join(td, "final.params"))
        data_state = it.state_dict()
        it.close()
        logging.info("rank %d img/s %.1f (global batch)  checkpoint %s  "
                     "input-stall %.0f%%  data epoch %d  loss %.4f -> %.4f",
                     dist.rank(), rate, os.path.basename(ckpt),
                     100.0 * mx.data.stall_fraction(), data_state["epoch"],
                     np.mean(losses[:5]), np.mean(losses[-5:]))
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise SystemExit("the step did not reduce the loss")
    return losses


if __name__ == "__main__":
    main()
