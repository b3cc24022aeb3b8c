"""The port's training scripts with ``--kv-store dist_sync``, launched as
a parameter-server job (two workers, one server) through the port's
launcher on the host, at a tiny size."""
import re
import sys

from mxnet_tpu_torch.parallel.launch import launch_local

ENV = {"OMP_NUM_THREADS": "2"}


def _run(args):
    cmd = [sys.executable, "-m"] + args
    codes, outs = launch_local(2, 1, cmd, env_extra=ENV, timeout=120,
                               capture=True)
    assert codes == [0, 0], "worker exit codes %s\n%s" % (
        codes, "\n".join(err[-4000:] for _, err in outs))
    return [out for out, _ in outs]


def test_train_mnist_dist_sync():
    outs = _run(["mxnet_tpu_torch.examples.train_mnist", "--synthetic",
                 "--cpu", "--kv-store", "dist_sync", "--num-epochs", "2",
                 "--num-examples", "1024", "--disp-batches", "4"])
    acc = [float(re.search(r"^final-accuracy ([0-9.]+)$", o, re.M).group(1))
           for o in outs]
    # Each worker trains its half of the data; the servers hold one set
    # of weights, so both score the same on the (unsplit) validation set.
    assert acc[0] == acc[1], acc
    assert acc[0] > 0.5, acc


def test_train_imagenet_dist_sync_benchmark():
    outs = _run(["mxnet_tpu_torch.examples.train_imagenet", "--device",
                 "cpu", "--benchmark", "1", "--kv-store", "dist_sync",
                 "--network", "resnet18", "--num-classes", "10",
                 "--image-shape", "3,32,32", "--batch-size", "4",
                 "--max-batches", "1"])
    for o in outs:
        m = re.search(r"^benchmark: resnet18 b4 float32 dist_sync on cpu\(0\):"
                      r" ([0-9.]+) img/s \(this worker\)$", o, re.M)
        assert m and float(m.group(1)) > 0, o
