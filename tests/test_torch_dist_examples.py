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


def test_train_ssd_dist_sync_workers_hold_the_same_weights():
    """Two workers train train_ssd against one server: both finish, rank
    0 prints final-loss, and their weights are identical."""
    code = (
        "import hashlib\n"
        "from mxnet_tpu_torch.examples import train_ssd as t\n"
        "out = t.train(t.parse_args(['--device', 'cpu', '--kv-store', "
        "'dist_sync', '--num-examples', '64', '--num-epochs', '2', "
        "'--batch-size', '16']))\n"
        "h = hashlib.sha256()\n"
        "for p in out['net'].collect_params().values():\n"
        "    h.update(p.data().asnumpy().tobytes())\n"
        "print('weights', h.hexdigest())\n")
    codes, outs = launch_local(2, 1, [sys.executable, "-c", code],
                               env_extra=ENV, timeout=120, capture=True)
    assert codes == [0, 0], "worker exit codes %s\n%s" % (
        codes, "\n".join(err[-4000:] for _, err in outs))
    digests = [re.search(r"^weights ([0-9a-f]+)$", o, re.M).group(1)
               for o, _ in outs]
    assert digests[0] == digests[1]
    assert sum(bool(re.search(r"^final-loss [0-9.]+ recall [0-9.]+$", o,
                              re.M)) for o, _ in outs) == 1
