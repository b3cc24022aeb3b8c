"""Train an MLP or LeNet on MNIST with the Module API.

Counterpart of ``examples/train_mnist.py`` (reference:
example/image-classification/train_mnist.py + common/fit.py — the
canonical symbolic training script: build a symbol, create a kvstore,
``Module.fit`` with metric and Speedometer callbacks), driving the port
on one device: ``gpu(0)`` unless ``--cpu`` is given. With ``--kv-store
dist_sync`` (or ``dist_async``) each worker of a parameter-server job
trains its shard of the data and the servers run the optimizer::

    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 1 \
        python -m mxnet_tpu_torch.examples.train_mnist --synthetic --cpu \
        --kv-store dist_sync

With ``--synthetic`` (or when ``--data-dir`` holds no MNIST files) the
script generates an MNIST-shaped synthetic classification set; nothing
is downloaded::

    python -m mxnet_tpu_torch.examples.train_mnist --synthetic \\
        [--network lenet] [--cpu]
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def get_mlp(mx):
    """(reference train_mnist.py:get_mlp)."""
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def get_lenet(mx):
    """(reference train_mnist.py:get_lenet)."""
    data = mx.sym.var("data")
    c1 = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20)
    a1 = mx.sym.Activation(c1, act_type="tanh")
    p1 = mx.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = mx.sym.Convolution(p1, kernel=(5, 5), num_filter=50)
    a2 = mx.sym.Activation(c2, act_type="tanh")
    p2 = mx.sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f1 = mx.sym.FullyConnected(p2, num_hidden=500)
    a3 = mx.sym.Activation(f1, act_type="tanh")
    f2 = mx.sym.FullyConnected(a3, num_hidden=10)
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def synthetic_arrays(num_examples, flat, seed=42):
    """MNIST-shaped synthetic digits: class = the row band holding the
    energy. Returns (X_train, y_train, X_val, y_val)."""
    rng = np.random.RandomState(seed)
    n = num_examples
    X = (rng.rand(n, 1, 28, 28) * 0.25).astype(np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        r = y[i] * 2 + 4
        X[i, 0, r:r + 3, 6:22] += 1.0
    if flat:
        X = X.reshape(n, 784)
    cut = int(n * 0.9)
    y = y.astype(np.float32)
    return X[:cut], y[:cut], X[cut:], y[cut:]


def iters(mx, args, flat, ctx, num_parts=1, part_index=0):
    have_mnist = os.path.exists(os.path.join(
        args.data_dir, "train-images-idx3-ubyte"))
    if not args.synthetic and have_mnist:
        prefix = args.data_dir
        train = mx.io.MNISTIter(
            image=os.path.join(prefix, "train-images-idx3-ubyte"),
            label=os.path.join(prefix, "train-labels-idx1-ubyte"),
            batch_size=args.batch_size, shuffle=True, flat=flat,
            num_parts=num_parts, part_index=part_index)
        val = mx.io.MNISTIter(
            image=os.path.join(prefix, "t10k-images-idx3-ubyte"),
            label=os.path.join(prefix, "t10k-labels-idx1-ubyte"),
            batch_size=args.batch_size, shuffle=False, flat=flat)
        return train, val
    Xt, yt, Xv, yv = synthetic_arrays(args.num_examples, flat)
    # Each worker of a dist job trains its own part of the data.
    Xt, yt = Xt[part_index::num_parts], yt[part_index::num_parts]
    train = mx.io.NDArrayIter(Xt, yt, batch_size=args.batch_size,
                              shuffle=True, label_name="softmax_label",
                              ctx=ctx)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=args.batch_size,
                            label_name="softmax_label", ctx=ctx)
    return train, val


def main(argv=None):
    import mxnet_tpu_torch as mx

    parser = argparse.ArgumentParser(description="train mnist")
    parser.add_argument("--network", default="mlp",
                        choices=["mlp", "lenet"])
    parser.add_argument("--cpu", action="store_true",
                        help="train on the host (default: gpu(0))")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--num-epochs", type=int, default=5)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--optimizer", default="sgd")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--num-examples", type=int, default=5000)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--disp-batches", type=int, default=50)
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mx.random.seed(args.seed)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    flat = args.network == "mlp"
    net = get_mlp(mx) if flat else get_lenet(mx)
    kv = args.kv_store
    parts = (1, 0)
    if "dist" in kv:
        kv = mx.kv.create(kv)
        parts = (kv.num_workers, kv.rank)
    with ctx:
        train, val = iters(mx, args, flat, ctx, *parts)
        mod = mx.mod.Module(net, context=ctx, label_names=["softmax_label"])
        checkpoint = (mx.callback.do_checkpoint(args.model_prefix)
                      if args.model_prefix else None)
        mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
                optimizer=args.optimizer,
                optimizer_params={"learning_rate": args.lr},
                initializer=mx.init.Xavier(magnitude=2.0),
                kvstore=kv, eval_metric="acc",
                batch_end_callback=mx.callback.Speedometer(
                    args.batch_size, args.disp_batches),
                epoch_end_callback=checkpoint)
        val.reset()
        acc = mod.score(val, mx.metric.Accuracy())[0][1]
    logging.info("final validation accuracy: %.4f", acc)
    print("final-accuracy %.4f" % acc, flush=True)
    return acc


if __name__ == "__main__":
    main()
