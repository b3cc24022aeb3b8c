"""Serve an MNIST MLP with the shape-bucketed batching inference server.

Counterpart of ``examples/serve_mnist.py``. The deployment lifecycle end
to end (reference: Module ``bind(for_training=False)`` +
save/load_checkpoint, c_predict_api): train (or random-init) an MLP,
``save_checkpoint`` it, load the artifact into
``serving.InferenceServer.from_checkpoint``, which runs one eval-mode
Executor per batch bucket at warmup, then fire concurrent single-image
requests from a thread pool. The dynamic batcher coalesces them into
bucket-sized device calls; the driver prints throughput, per-bucket
occupancy and p50/p99 latency, plus a deadline-shedding demonstration.

With an existing artifact: ``--checkpoint prefix --epoch N``. Without
one, a synthetic-MNIST checkpoint is created in a temporary directory;
nothing is downloaded::

    python -m mxnet_tpu_torch.examples.serve_mnist [--cpu]
        [--train-epochs 0] [--requests 256]
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def build_mlp(mx):
    """(reference train_mnist.py:get_mlp, narrowed for a serving demo)."""
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def synthetic_digits(n, seed=42):
    """MNIST-shaped synthetic digits: class = row-band position,
    flattened to 784."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(n, 28, 28) * 0.25).astype(np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        r = y[i] * 2 + 4
        X[i, r:r + 3, 6:22] += 1.0
    return X.reshape(n, 784), y


def make_checkpoint(mx, args, ctx, Xtr, ytr, prefix):
    """Produce the serving artifact: fit (or just init) +
    save_checkpoint. Returns its epoch."""
    mod = mx.mod.Module(build_mlp(mx), context=ctx,
                        label_names=["softmax_label"])
    if args.train_epochs > 0:
        train = mx.io.NDArrayIter(Xtr, ytr.astype(np.float32),
                                  batch_size=args.batch_size, shuffle=True,
                                  label_name="softmax_label")
        mod.fit(train, num_epoch=args.train_epochs, optimizer="sgd",
                optimizer_params={"learning_rate": args.lr},
                initializer=mx.init.Xavier(magnitude=2.0))
    else:
        mod.bind(data_shapes=[("data", (args.batch_size, 784))],
                 label_shapes=[("softmax_label", (args.batch_size,))])
        mod.init_params(mx.init.Xavier(magnitude=2.0))
    mod.save_checkpoint(prefix, args.train_epochs)
    return args.train_epochs


def main(argv=None):
    """Run the demo; returns its figures (accuracy, req/s, p99, shed)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    parser = argparse.ArgumentParser(description="serve mnist")
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the host instead of gpu(0)")
    parser.add_argument("--checkpoint", default=None,
                        help="existing save_checkpoint prefix to serve")
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--train-epochs", type=int, default=2,
                        help="0 = random-init checkpoint (lifecycle only)")
    parser.add_argument("--num-examples", type=int, default=1500)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--requests", type=int, default=256,
                        help="concurrent single-image requests to fire")
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--max-delay-ms", type=float, default=5.0)
    parser.add_argument("--max-queue", type=int, default=512)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)

    X, y = synthetic_digits(args.num_examples)
    cut = int(len(X) * 0.9)
    Xte, yte = X[cut:], y[cut:]

    tmp = None
    if args.checkpoint:
        prefix, epoch = args.checkpoint, args.epoch
    else:
        tmp = tempfile.TemporaryDirectory()
        prefix = os.path.join(tmp.name, "mnist_mlp")
        with ctx:   # the data iterator's arrays live where the Module runs
            epoch = make_checkpoint(mx, args, ctx, X[:cut], y[:cut], prefix)

    t0 = time.perf_counter()
    srv = serving.InferenceServer.from_checkpoint(
        prefix, epoch, item_shape=(784,), max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, max_queue=args.max_queue, ctx=ctx)
    print("warmup: buckets %s -> %d signatures in %.2f s"
          % (list(srv.policy.buckets), srv.compile_count,
             time.perf_counter() - t0))
    try:
        # Concurrent load: each request is ONE image; the batcher
        # coalesces them.
        reqs = [Xte[i % len(Xte)][None, :] for i in range(args.requests)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(args.concurrency) as pool:
            futs = list(pool.map(srv.submit, reqs))
        preds = [int(np.argmax(f.result().asnumpy())) for f in futs]
        dt = time.perf_counter() - t0
        acc = float(np.mean([p == yte[i % len(Xte)]
                             for i, p in enumerate(preds)]))

        # Deadline shedding: a paused server expires a 1 ms request.
        srv.pause()
        doomed = srv.submit(Xte[:1], timeout_ms=1)
        time.sleep(0.02)
        srv.resume()
        try:
            doomed.result(timeout=5)
        except serving.DeadlineExceededError:
            pass

        stats = srv.stats()
        for bucket, st in sorted(stats["buckets"].items()):
            print("bucket %-3d: %3d batches, %4d requests, occupancy %.2f, "
                  "p50 %.2f ms, p99 %.2f ms"
                  % (bucket, st["batches"], st["requests"],
                     st["mean_occupancy"], st["p50_ms"], st["p99_ms"]))
        print("shed:", stats["shed"])
        p99 = max(st["p99_ms"] for st in stats["buckets"].values())
    finally:
        srv.shutdown()
        if tmp is not None:
            tmp.cleanup()
    print("served-accuracy %.4f" % acc)
    print("serving-throughput %.1f req/s  p99-ms %.2f"
          % (args.requests / dt, p99))
    return {"accuracy": acc, "requests": len(preds),
            "req_per_s": args.requests / dt, "p99_ms": p99,
            "shed": stats["shed"], "compile_count": srv.compile_count}


if __name__ == "__main__":
    main()
