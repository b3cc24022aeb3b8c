"""Rank program of the port's tensor-parallel tests (tests/test_torch_tp.py).

Launched by ``mxnet_tpu_torch.parallel.launch`` as an SPMD group over
gloo on the host (``torch_dist_prog.launch(..., prog=PROG)``). Each rank
trains the nets of :func:`tp_block` and :func:`tp_dense_bn_dense` from
the weights and global batches in ``--data`` and writes what the tests
compare to ``--out`` (one ``.npz`` per rank and mode):

- ``tp4`` (4 ranks, ``{"dp": 2, "tp": 2}``): both nets with SGD and
  momentum against the JAX package's step, the block also under
  :func:`dp_tp_rule` (weights split over ``dp`` too); ``place`` then
  ``gather`` of a tensor under three specs; the block under every
  optimizer of ``VARIANTS``; a sharded checkpoint of the block's SGD
  run (``CheckpointManager`` in the data's ``ckpt`` directory, and
  ``save_checkpoint`` beside it), the gathered state and the next step's
  loss; the block's SGD run with the ranks at ``tp`` index 1 computing
  other bits (:func:`drift`), and each rank's own live state.
- ``tp2`` (2 ranks): ``{"dp": 1, "tp": 2}`` and the single-device step
  in the same rank, and ``{"dp": 2}``, under every variant (the tp2 SGD
  step's ``sync_to_net`` too); then the
  ``tp4`` checkpoint restored on ``{"dp": 1, "tp": 2}`` and on one
  device (and its ``.params`` file on ``{"dp": 1, "tp": 2}``), and the JAX package's ``{"dp": 2, "tp": 4}`` checkpoint (the
  data's ``jax_ckpt``) on ``{"dp": 1, "tp": 2}``, with their next
  losses.
- ``card`` (2 ranks on one card, ``{"dp": 1, "tp": 2}``, cuDNN's
  default algorithms): :func:`card_net` for ``STEPS`` steps from a
  seed, each rank's own live state.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import mxnet_tpu_torch as mx  # noqa: E402

PROG = os.path.abspath(__file__)
STEPS = 3          # steps before the checkpoint and of each variant
JAX_STEPS = 4      # steps held against the JAX package's step
BATCH = 8          # the global batch
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}
# (family, optimizer_params, compute dtype) of the bit-for-bit runs;
# lbsgd's runs take one step (LBSGD_STEPS): its trust ratio moves by a
# few units of the last place under tp, and later steps amplify that.
LBSGD_STEPS = 1
VARIANTS = {
    "sgd": ("sgd", OPT, None),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01}, None),
    "bf16": ("sgd", OPT, "bfloat16"),
    "lbsgd": ("lbsgd", OPT, None),
}


def tp_block(pkg):
    """The ResNet basic block of tests/test_parallel.py's tp test, with
    fixed names (the same in both packages and every process)."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="blk_")
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=4, prefix="c1_"),
            nn.BatchNorm(in_channels=8, prefix="bn1_"),
            nn.Activation("relu", prefix="relu_"),
            nn.Conv2D(8, 3, padding=1, in_channels=8, prefix="c2_"),
            nn.BatchNorm(in_channels=8, prefix="bn2_"),
            nn.Flatten(prefix="flat_"),
            nn.Dense(4, in_units=512, prefix="fc_"))
    return net


def tp_dense_bn_dense(pkg):
    """tests/torch_dist_prog.py's Dense-BN-Dense with fixed names."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="dbd_")
    net.add(nn.Dense(8, in_units=4, prefix="a_"),
            nn.BatchNorm(in_channels=8, prefix="bn_"),
            nn.Dense(2, in_units=8, prefix="b_"))
    return net


NETS = {"blk": tp_block, "dbd": tp_dense_bn_dense}


def dp_tp_rule(P):
    """A placement rule (for either package's spec type `P`) that splits
    every weight's first dimension over ``("dp", "tp")``: the rank's
    block is a quarter of it on a dp2 x tp2 mesh."""
    def rule(name, shape, mesh):
        n = mesh.shape["dp"] * mesh.shape["tp"]
        if len(shape) >= 2 and shape[0] % n == 0:
            return P(("dp", "tp"), *[None] * (len(shape) - 1))
        return P()

    return rule


def state_arrays(step, tag, out):
    """The step's full state (every rank calls it: a split array is
    gathered) as ``<tag>:p:``, ``<tag>:s<i>:`` and ``<tag>:a:`` keys."""
    params, opt, aux = step.state_to_host()
    for n, v in params.items():
        out["%s:p:%s" % (tag, n)] = v
        for i, s in enumerate(opt[n]):
            out["%s:s%d:%s" % (tag, i, n)] = s
    for n, v in aux.items():
        out["%s:a:%s" % (tag, n)] = v


class Runner:
    def __init__(self, data):
        self.data = data

    def step(self, kind, variant, mesh, param_rule=None):
        from mxnet_tpu_torch.gluon.utils import params_from_numpy
        from mxnet_tpu_torch.parallel import TrainStep

        d = self.data
        pre = kind + ":w:"
        with mx.cpu():
            net = NETS[kind](mx)
            net.initialize(ctx=mx.cpu())
        params_from_numpy(net, {k[len(pre):]: d[k] for k in d.files
                                if k.startswith(pre)})
        family, opt, dtype = VARIANTS[variant]
        return TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         family, dict(opt), mesh=mesh, dtype=dtype,
                         param_rule=param_rule)

    def train(self, step, kind, mesh, steps, start=0):
        xs, ys = self.data[kind + ":x"], self.data[kind + ":y"]
        lo, hi = mesh.local_slice(xs.shape[1])
        return np.array([float(step(x[lo:hi], y[lo:hi]))
                         for x, y in zip(xs[start:start + steps],
                                         ys[start:start + steps])],
                        np.float32)

    def run(self, kind, variant, mesh, steps, tag, out, param_rule=None):
        if variant == "lbsgd":
            steps = LBSGD_STEPS
        step = self.step(kind, variant, mesh, param_rule)
        out[tag + ":loss"] = self.train(step, kind, mesh, steps)
        state_arrays(step, tag, out)
        return step


def drift(step, mesh, by=1e-3):
    """Make the ranks at ``tp`` index 1 of `mesh` compute other bits, as
    nondeterministic kernels would: their loss, gradients and new aux
    values move by `by` before the step syncs its replicas."""
    if mesh.axis_index("tp") == 0:
        return
    real = step._loss_and_grads

    def moved(*a, **k):
        loss, grads, aux = real(*a, **k)
        return (loss + by, {n: g + by for n, g in grads.items()},
                {n: v + by for n, v in aux.items()})

    step._loss_and_grads = moved


def live_arrays(step, tag, out):
    """This rank's own tensors (blocks of the split ones, no gather) as
    ``<tag>:p:``, ``<tag>:s<i>:`` and ``<tag>:a:`` keys, and the names
    of the split parameters as ``<tag>:split``."""
    def host(t):
        return t.detach().to("cpu", copy=True).numpy()

    for n, v in step._param_vals.items():
        out["%s:p:%s" % (tag, n)] = host(v)
        for i, s in enumerate(step._opt_state[n]):
            out["%s:s%d:%s" % (tag, i, n)] = host(s)
    for n, v in step._aux_vals.items():
        out["%s:a:%s" % (tag, n)] = host(v)
    out[tag + ":split"] = np.array(sorted(
        n for n in step._param_vals if step._split(n) is not None))


def card_net(pkg):
    """Two 3x3 convolutions of 64 channels with BatchNorm and a dense
    head, big enough for cuDNN to pick its fast weight-gradient
    algorithms."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="card_")
    net.add(nn.Conv2D(64, 3, padding=1, in_channels=16, prefix="c1_"),
            nn.BatchNorm(in_channels=64, prefix="bn1_"),
            nn.Activation("relu", prefix="relu_"),
            nn.Conv2D(64, 3, padding=1, in_channels=64, prefix="c2_"),
            nn.BatchNorm(in_channels=64, prefix="bn2_"),
            nn.GlobalAvgPool2D(prefix="pool_"),
            nn.Dense(10, in_units=64, prefix="fc_"))
    return net


def held_numel(step):
    """(elements of parameters and optimizer state this rank holds,
    elements of the full arrays)."""
    held = full = 0
    for n, v in step._param_vals.items():
        k = 1 + len(step._opt_state[n])
        held += v.numel() * k
        full += int(np.prod(step._shapes[n])) * k
    return held, full


def run_tp4(args, run, out):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import (NamedSharding, P, gather,
                                          make_mesh, place)

    mesh = make_mesh({"dp": 2, "tp": 2})
    for kind in ("dbd", "blk"):
        step = run.run(kind, "sgd", mesh, JAX_STEPS, "jax_" + kind, out)
        out["held:" + kind] = np.array(held_numel(step))
    step = run.run("blk", "sgd", mesh, JAX_STEPS, "rule_blk", out,
                   param_rule=dp_tp_rule(P))
    out["held:rule_blk"] = np.array(held_numel(step))
    full = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    for i, spec in enumerate((P(("dp", "tp"), None), P(None, "tp"),
                              P("tp", "dp"))):
        s = NamedSharding(mesh, spec)
        out["place_gather:%d" % i] = gather(place(full, s), s).numpy()
    for variant in VARIANTS:
        step = run.run("blk", variant, mesh, STEPS, "bit_" + variant, out)
        if variant != "sgd":
            continue
        sd = step.state_dict(sharded=True)
        CheckpointManager(args.ckpt).save(STEPS, sd, sync=True)
        step.save_checkpoint(args.ckpt + ".params")
        state_arrays(step, "ckpt", out)
        out["ckpt:next_loss"] = run.train(step, "blk", mesh, 1, STEPS)
    step = run.step("blk", "sgd", mesh)
    drift(step, mesh)
    out["drift:loss"] = run.train(step, "blk", mesh, STEPS)
    live_arrays(step, "drift", out)


def run_tp2(args, run, out):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import make_mesh

    tp = make_mesh({"dp": 1, "tp": 2})
    single = make_mesh({"dp": 1}, devices=[mx.cpu()])
    for variant in VARIANTS:
        step = run.run("blk", variant, tp, STEPS, "tp2_" + variant, out)
        run.run("blk", variant, single, STEPS, "single_" + variant, out)
        if variant == "sgd":
            step.sync_to_net()
            for n, p in step.net.collect_params().items():
                out["sync:" + n] = p.data().asnumpy()
    dp = make_mesh({"dp": 2})
    for variant in VARIANTS:
        run.run("blk", variant, dp, STEPS, "dp2_" + variant, out)
    for tag, where, mesh in (("restore_port", args.ckpt, tp),
                             ("restore_single", args.ckpt, single),
                             ("restore_jax", args.jax_ckpt, tp)):
        step = run.step("blk", "sgd", mesh)
        _, state = CheckpointManager(where).restore()
        step.load_state_dict(state)
        state_arrays(step, tag, out)
        out[tag + ":next_loss"] = run.train(step, "blk", mesh, 1, STEPS)
    step = run.step("blk", "sgd", tp)
    step.load_checkpoint(args.ckpt + ".params")
    state_arrays(step, "restore_params", out)


def run_card(out):
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    mesh = make_mesh({"dp": 1, "tp": 2})
    mx.random.seed(0)
    with mx.gpu(0):
        net = card_net(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=mesh)
    rng = np.random.default_rng(0)
    out["card:loss"] = np.array([float(step(
        torch.from_numpy(rng.random((32, 16, 32, 32), dtype=np.float32))
        .cuda(), torch.from_numpy(rng.integers(0, 10, 32)
                                  .astype(np.float32)).cuda()))
        for _ in range(STEPS)], np.float32)
    live_arrays(step, "card", out)


def main():
    from mxnet_tpu_torch.parallel import dist

    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=["tp4", "tp2", "card"])
    parser.add_argument("--data")
    parser.add_argument("--out")
    args = parser.parse_args()
    out = {}
    if args.mode == "card":
        assert dist.initialize(backend="gloo", platform="gpu")
        run_card(out)
    else:
        assert dist.initialize(backend="gloo", platform="cpu")
        data = np.load(args.data)
        args.ckpt, args.jax_ckpt = str(data["ckpt"]), str(data["jax_ckpt"])
        globals()["run_" + args.mode](args, Runner(data), out)
    np.savez(os.path.join(args.out, "%s_r%d.npz" % (args.mode,
                                                    dist.rank())), **out)


if __name__ == "__main__":
    main()
