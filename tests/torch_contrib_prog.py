"""Rank program of tests/test_torch_gluon_contrib.py: ``SyncBatchNorm``
in the dp ``TrainStep`` over the group's ranks (gloo on the host), each
rank feeding its slice of the global batch. Started by
``torch_dist_prog.launch(..., prog=<this file>)``; writes
``syncbn_r<rank>.npz`` under ``--out``."""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import mxnet_tpu_torch as mx  # noqa: E402

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}


def dense_syncbn_dense(pkg):
    """Dense-SyncBatchNorm-Dense, for either package."""
    from importlib import import_module

    cnn = import_module(pkg.__name__ + ".gluon.contrib.nn")
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4))
    net.add(cnn.SyncBatchNorm(in_channels=8, num_devices=2))
    net.add(pkg.gluon.nn.Dense(2, in_units=8))
    return net


def run_syncbn(args):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh

    assert dist.initialize(backend="gloo", platform="cpu")
    data = np.load(args.data)
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w:")}
    xs, ys = data["x"], data["y"]
    lo, hi = dist.local_slice(xs.shape[1])
    with mx.cpu():
        net = dense_syncbn_dense(mx)
        net.initialize(ctx=mx.cpu())
    params_from_numpy(net, weights, prefix=str(data["prefix"]))
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=make_mesh({"dp": -1}))
    out = {"loss": np.array([float(step(x[lo:hi], y[lo:hi]))
                             for x, y in zip(xs, ys)], np.float32)}
    params, opt_state, aux = step.state_to_host()
    rel = relative_names(list(params) + list(aux), net.prefix)
    for n, v in params.items():
        out["p:" + rel[n]] = v
        out["m:" + rel[n]] = opt_state[n][0]
    for n, v in aux.items():
        out["a:" + rel[n]] = v
    np.savez(os.path.join(args.out, "syncbn_r%d.npz" % dist.rank()), **out)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", default="syncbn", choices=["syncbn"])
    parser.add_argument("--data", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    run_syncbn(args)


if __name__ == "__main__":
    main()
