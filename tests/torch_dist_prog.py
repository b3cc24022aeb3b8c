"""Worker program of the port's multi-process tests.

Launched by ``mxnet_tpu_torch.parallel.launch`` with scheduler and
server siblings (the ``dist_*`` modes) or as an SPMD group (``-s 0``,
the ``spmd_*`` modes). Server and scheduler processes block inside
``import mxnet_tpu_torch`` (the kvstore_server bootstrap) and never
reach ``main()``. Workers run on the host (``ctx=mx.cpu()``, gloo), do
their checks, write what the test compares to ``--out`` (one ``.npz``
per rank) and exit 0; the tests assert every worker's exit code.

The kvstore modes are the port's counterparts of ``tests/dist_prog.py``:
closed-form push/pull values with and without an optimizer on the
servers, a key split across servers, a float64 key, two-bit
compression, async updates, failure detection and a Trainer.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import mxnet_tpu_torch as mx  # noqa: E402  (server roles exit here)

PROG = os.path.abspath(__file__)


def launch(num_workers, num_servers, mode, out, data=None, kv_type=None,
           env=None, timeout=120, prog=PROG):
    """Run `prog` (default: this program) as `num_workers` workers (and a
    scheduler with `num_servers` servers) through the port's launcher,
    with free ports and a timeout; asserts every worker exited 0, with
    their stderr."""
    from mxnet_tpu_torch.parallel.launch import launch_local

    cmd = [sys.executable, prog, "--mode", mode, "--out", str(out)]
    if data is not None:
        cmd += ["--data", str(data)]
    if kv_type is not None:
        cmd += ["--kv-type", kv_type]
    env_extra = {"MXNET_TEST_OUT": str(out), "OMP_NUM_THREADS": "2"}
    env_extra.update(env or {})
    codes, outs = launch_local(num_workers, num_servers, cmd,
                               env_extra=env_extra, timeout=timeout,
                               capture=True)
    assert codes == [0] * num_workers, "worker exit codes %s\n%s" % (
        codes, "\n".join(err[-4000:] for _, err in outs))


SHAPE = (3, 3)
BIG_SHAPE = (100, 120)          # 12000 elements > the bound the test sets
RATE = 0.3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def check(actual, expected, what, rtol=1e-5, atol=1e-6):
    if not np.allclose(actual, expected, rtol=rtol, atol=atol):
        raise AssertionError("%s mismatch:\n%r\nvs expected\n%r"
                             % (what, actual, expected))


def nd(value, dtype="float32", ctx=None):
    return mx.nd.array(np.asarray(value), ctx=ctx or mx.cpu(), dtype=dtype)


def run_sync(kv):
    nw = kv.num_workers
    my = kv.rank + 1
    total = nw * (nw + 1) // 2
    ones = np.ones(SHAPE, np.float32)
    big_ones = np.ones(BIG_SHAPE, np.float32)

    kv.init("3", nd(np.zeros(SHAPE)))
    kv.init("99", nd(np.zeros(BIG_SHAPE)))
    # The big key is split across both servers.
    assert len(kv._shards("99", BIG_SHAPE)) == 2, kv._shards("99", BIG_SHAPE)

    # Phase 1: no optimizer, the server assigns the aggregated sum.
    kv.push("3", nd(ones * my))
    kv.push("99", nd(big_ones * my))
    out, big = nd(np.zeros(SHAPE)), nd(np.zeros(BIG_SHAPE))
    kv.pull("3", out=out)
    kv.pull("99", out=big)
    check(out.asnumpy(), np.full(SHAPE, total), "sync assign small")
    check(big.asnumpy(), np.full(BIG_SHAPE, total), "sync assign big/split")

    # Phase 2: the Test optimizer on the servers, stored += rate * sum.
    kv.set_optimizer(mx.optimizer.create("test", rescale_grad=RATE))
    nrepeat = 3
    for _ in range(nrepeat):
        kv.push("3", nd(ones * my))
        kv.push("99", nd(big_ones * my))
    kv.pull("3", out=out)
    kv.pull("99", out=big)
    expected = total + nrepeat * RATE * total
    check(out.asnumpy(), np.full(SHAPE, expected), "sync optimizer small")
    check(big.asnumpy(), np.full(BIG_SHAPE, expected), "sync optimizer big")

    # Phase 3: values on two local contexts merge before the wire.
    devvals = [nd(ones * my, ctx=mx.cpu(d)) for d in range(2)]
    kv.push("3", devvals)
    outs = [nd(np.zeros(SHAPE), ctx=mx.cpu(d)) for d in range(2)]
    kv.pull("3", out=outs)
    expected += RATE * total * 2
    for o in outs:
        check(o.asnumpy(), np.full(SHAPE, expected), "multi-context push")

    # Phase 4: pushpull and pull_async.
    kv.pushpull("3", nd(ones * my), out=out)
    expected += RATE * total
    check(out.asnumpy(), np.full(SHAPE, expected), "pushpull")
    h = kv.pull_async("3", out=out)
    h.wait(timeout=60)
    check(out.asnumpy(), np.full(SHAPE, expected), "pull_async")

    # Phase 5: a float64 key stays float64 across the wire.
    v64 = np.full(SHAPE, 1.0 + 2.0 ** -40, np.float64)
    kv.init("f64", nd(np.zeros(SHAPE), dtype="float64"))
    kv.push("f64", nd(v64 * my, dtype="float64"))
    o64 = nd(np.zeros(SHAPE), dtype="float64")
    kv.pull("f64", out=o64)
    got = o64.asnumpy()
    assert got.dtype == np.float64, got.dtype
    # The server sums the pushes and runs the Test optimizer in float64:
    # w = 0 + sum * RATE; 2**-40 is below float32's resolution at 1.
    want = 0.0 + (v64 * total) * RATE
    if not np.array_equal(got, want) or \
            np.array_equal(want, want.astype(np.float32)):
        raise AssertionError("float64 key: %r vs %r" % (got, want))

    # Phase 6: 2-bit compression, the lossless case (|v| == threshold).
    kv.init("comp", nd(np.zeros(SHAPE)))
    kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    kv.push("comp", nd(ones))
    cout = nd(np.zeros(SHAPE))
    kv.pull("comp", out=cout)
    check(cout.asnumpy(), np.full(SHAPE, RATE * nw), "2bit compressed push")

    # Phase 7: row-sparse push and pull of selected rows (the optimizer
    # above runs on the servers: stored += rate * sum of the pushes).
    rsp_shape = (10, 4)
    kv.init("rsp", nd(np.zeros(rsp_shape)).tostype("row_sparse"))
    rows = np.array([1, 5, 7], np.int64)
    kv.push("rsp", mx.nd.sparse.row_sparse_array(
        (np.full((3, rsp_shape[1]), float(my), np.float32), rows),
        shape=rsp_shape, ctx=mx.cpu()))
    out_r = nd(np.zeros((3, rsp_shape[1])))
    kv.row_sparse_pull("rsp", out=out_r,
                       row_ids=nd([0, 1, 5], dtype="int64"))
    want = np.zeros(rsp_shape, np.float32)
    want[rows] = RATE * total
    check(out_r.asnumpy(), want[[0, 1, 5]], "row_sparse_pull rows")
    # A row-sparse key larger than the big-array bound stays whole on one
    # server, and still pushes and pulls rows.
    big_rsp = (900, 5)          # 4500 elements > the bound of 4000
    kv.init("rsp_big", nd(np.zeros(big_rsp)).tostype("row_sparse"))
    assert len(kv._shards("rsp_big", big_rsp, "row_sparse")) == 1
    rows_b = np.array([3, 870], np.int64)
    kv.push("rsp_big", mx.nd.sparse.row_sparse_array(
        (np.full((2, 5), float(my), np.float32), rows_b), shape=big_rsp,
        ctx=mx.cpu()))
    out_b = mx.nd.sparse.zeros("row_sparse", (2, 5), ctx=mx.cpu())
    kv.row_sparse_pull("rsp_big", out=out_b,
                       row_ids=nd(rows_b, dtype="int64"))
    check(out_b.data.asnumpy(), np.full((2, 5), RATE * total),
          "big rsp rows")
    check(out_b.indices.asnumpy(), rows_b, "big rsp row ids")

    # Optimizer state lives on the servers: it round-trips.
    tag = os.environ["DMLC_PS_ROOT_PORT"]
    path = os.path.join(os.environ["MXNET_TEST_OUT"], "states_%s" % tag)
    if kv.rank == 0:
        kv.save_optimizer_states(path)
    kv._barrier()
    kv.load_optimizer_states(path)
    log("rank", kv.rank, "sync ok")


def run_async(kv):
    my = kv.rank + 1
    nw = kv.num_workers
    total = nw * (nw + 1) // 2
    kv.init("a", nd(np.zeros(SHAPE)))
    kv.set_optimizer(mx.optimizer.create("test", rescale_grad=1.0))
    nrepeat = 4
    for _ in range(nrepeat):
        kv.push("a", nd(np.ones(SHAPE) * my))
    # Async pushes are acked after the server applied them, so after the
    # barrier every worker's updates have landed.
    kv._barrier()
    out = nd(np.zeros(SHAPE))
    kv.pull("a", out=out)
    check(out.asnumpy(), np.full(SHAPE, nrepeat * total), "async updates")
    log("rank", kv.rank, "async ok")


def run_failure(kv):
    """Rank 1 dies without finalizing; rank 0 sees it in get_dead_nodes
    and its next barrier fails loudly instead of hanging."""
    import time

    kv.init("f", nd(np.zeros((2,))))
    if kv.rank == 1:
        os._exit(0)          # a crash: no finalize, no atexit
    deadline = time.time() + 60
    dead = []
    while time.time() < deadline:
        dead = kv.get_dead_nodes(timeout=30)
        if 1 in dead:
            break
        time.sleep(0.5)
    assert 1 in dead, "dead worker not detected: %r" % (dead,)
    try:
        kv._barrier()
    except RuntimeError:
        pass
    else:
        raise AssertionError("barrier succeeded despite a dead worker")
    log("failure detection ok")


def run_trainer(kv, args):
    """A dist_sync Trainer: each worker trains its half of the global
    batch, SGD runs on the server, and every worker pulls the same
    weights. ``trainer.step`` takes the global batch size, so the
    server's update is the single-process Trainer's on the global
    batch."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    data = np.load(args.data)
    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(8, in_units=4, activation="tanh"))
        net.add(gluon.nn.Dense(2, in_units=8))
        net.initialize(ctx=mx.cpu())
    params_from_numpy(net, {k[2:]: data[k] for k in data.files
                            if k.startswith("w:")},
                      prefix=str(data["prefix"]))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=kv)
    loss_fn = gluon.loss.L2Loss()
    xs, ys = data["x"], data["y"]
    n = xs.shape[1] // kv.num_workers
    sl = slice(kv.rank * n, (kv.rank + 1) * n)
    for step in range(xs.shape[0]):
        x, y = nd(xs[step][sl]), nd(ys[step][sl])
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(xs.shape[1])
    assert trainer._update_on_kvstore
    params = net.collect_params()
    rel = gluon.utils.relative_names(list(params.keys()), net.prefix)
    out = {"p:" + rel[k]: p.data().asnumpy() for k, p in params.items()}
    np.savez(os.path.join(args.out, "trainer_r%d.npz" % kv.rank), **out)


def run_overlap_compressed(kv, args):
    """The overlapped bucketed reduce (update_on_kvstore=False, two
    1 MB buckets) through the store with 2-bit compression: the
    worker-side error-feedback residuals key by the buckets' shard
    subkeys and persist across steps, and the workers end with the same
    weights."""
    from mxnet_tpu_torch import gluon

    os.environ["MXNET_FUSED_OVERLAP_DEPTH"] = "2"
    os.environ["MXNET_FUSED_BUCKET_MB"] = "1"
    n, size = 40, 8192
    rng = np.random.RandomState(5)
    params = []
    for k in range(n):
        p = gluon.Parameter("ovc_%d" % k, shape=(size,))
        p.initialize(init=mx.init.Constant(0.0), ctx=mx.cpu())
        p.set_data(rng.randn(size).astype(np.float32))
        params.append(p)
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                            "momentum": 0.9},
                            kvstore=kv, update_on_kvstore=False,
                            compression_params={"type": "2bit",
                                                "threshold": 0.05})
    grads = np.random.RandomState(100 + kv.rank)
    seen = None
    for step in range(3):
        for p in params:
            p.grad()[:] = grads.randn(size).astype(np.float32)
        trainer.step(2)
        res = kv._compression._residual
        keys = sorted(str(k) for k in res if "__fused_grad_bucket" in str(k))
        assert len(keys) == 2, keys
        sig = {k: float(res[k].sum()) for k in res
               if "__fused_grad_bucket" in str(k)}
        if seen is not None:
            assert set(sig) == set(seen), "residual keys churned"
            assert any(sig[k] != seen[k] for k in sig), "residuals frozen"
        seen = sig
    assert not trainer._update_on_kvstore
    np.savez(os.path.join(args.out, "overlap_r%d.npz" % kv.rank),
             w=np.concatenate([p.data().asnumpy() for p in params]))


def run_module(kv, args):
    """Module(context=[cpu(0), cpu(1)]) with the dist_sync store: each
    worker fits its half of every global batch (the batch sliced over
    its two contexts, the two merged before the push); the server runs
    SGD with rescale 1/(batch * workers)."""
    data = np.load(args.data)
    xs, ys = data["x"], data["y"]
    n = xs.shape[1] // kv.num_workers
    sl = slice(kv.rank * n, (kv.rank + 1) * n)
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=ctxs)
    it = mx.io.NDArrayIter(xs[:, sl].reshape(-1, xs.shape[2]),
                           ys[:, sl].reshape(-1), batch_size=n,
                           label_name="softmax_label", ctx=mx.cpu())
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k[2:]: nd(data[k]) for k in data.files
                        if k.startswith("w:")})
    assert mod._update_on_kvstore and len(mod._execs) == 2
    out = {"p:" + k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    np.savez(os.path.join(args.out, "module_r%d.npz" % kv.rank), **out)


# -- SPMD modes (parallel.dist over gloo) -------------------------------------

def dense_bn_dense(pkg):
    """The Dense-BN-Dense net of tests/test_torch_train_step.py, for
    either package."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4))
    net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(2, in_units=8))
    return net


OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}


def run_spmd_basic(args):
    from mxnet_tpu_torch.parallel import dist, make_mesh
    from mxnet_tpu_torch.parallel import collectives as coll

    assert dist.initialize(backend="gloo", platform="cpu")
    r, n = dist.rank(), dist.num_processes()
    dist.barrier()
    out = {"rank": r, "n": n, "slice": np.array(dist.local_slice(8))}
    try:
        dist.local_slice(8 * n + 1)
        out["uneven_raised"] = False
    except ValueError:
        out["uneven_raised"] = True
    mesh = make_mesh({"dp": -1})
    out["dp_shape"] = np.array([mesh.shape["dp"]])
    if n == 4:
        m2 = make_mesh({"dp": 2, "sp": -1})
        out["m2_shape"] = np.array([m2.shape["dp"], m2.shape["sp"]])
        out["m2_coords"] = np.array([m2.coords()["dp"], m2.coords()["sp"]])
        out["m2_dp_ranks"] = np.array(m2.axis_ranks("dp"))
        out["m2_sp_ranks"] = np.array(m2.axis_ranks("sp"))
        t = torch.tensor([float(r)])
        out["sp_sum"] = coll.all_reduce(t, m2.group("sp")).numpy()
        out["dp_sum"] = coll.all_reduce(t, m2.group("dp")).numpy()
    # The rank's device stream: a function of the root seed and rank,
    # repeated by a reseed.
    draws = []
    for _ in range(2):
        mx.random.seed(5)
        draws.append(torch.rand(6, generator=mx.random.generator(
            mx.cpu())).numpy())
    out["draw0"], out["draw1"] = draws
    out["cuda_initialized"] = torch.cuda.is_initialized()
    np.savez(os.path.join(args.out, "basic_r%d.npz" % r), **out)


def _state(step, net, tag, out):
    from mxnet_tpu_torch.gluon.utils import relative_names

    params, opt_state, aux = step.state_to_host()
    rel = relative_names(list(params) + list(aux), net.prefix)
    for n, v in params.items():
        out["%s:p:%s" % (tag, rel[n])] = v
        out["%s:m:%s" % (tag, rel[n])] = opt_state[n][0]
    for n, v in aux.items():
        out["%s:a:%s" % (tag, rel[n])] = v


def run_spmd_trainstep(args):
    """Three SGD-momentum steps of the Dense-BN-Dense net over a dp
    mesh of the group's ranks, each rank feeding its local slice: the
    dp step, the deterministic step, and (to show what the global
    BatchNorm statistics change) a step whose BatchNorm uses each
    rank's own statistics, as DDP's does. At one rank the dp step is
    also held bit for bit against the single-device step here."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh
    from mxnet_tpu_torch.parallel import collectives as coll

    class PerRankBN(TrainStep):
        def _dp_loss_and_grads(self, x, y):
            group = self._dp_group
            share = 1.0 / coll.group_size(group)
            loss, grads, aux = self._loss_and_grads(x, y, share=share)
            names = list(grads)
            summed = coll.all_reduce_flat(
                [loss.reshape(1)] + [grads[n] for n in names], group)
            return summed[0].reshape(()), dict(zip(names, summed[1:])), aux

    assert dist.initialize(backend="gloo", platform="cpu")
    data = np.load(args.data)
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w:")}
    xs, ys = data["x"], data["y"]
    lo, hi = dist.local_slice(xs.shape[1])
    out = {}

    def build():
        with mx.cpu():
            net = dense_bn_dense(mx)
            net.initialize(ctx=mx.cpu())
        params_from_numpy(net, weights, prefix=str(data["prefix"]))
        return net

    variants = [("dp", TrainStep, {}),
                ("det", TrainStep, {"deterministic_reduction": True}),
                ("perrank", PerRankBN, {})]
    if dist.num_processes() == 1:
        variants.append(("single", TrainStep, {}))
    for tag, cls, kw in variants:
        net = build()
        mesh = make_mesh({"dp": 1}, devices=[mx.cpu()]) \
            if tag == "single" else make_mesh({"dp": -1})
        step = cls(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                   dict(OPT), mesh=mesh, **kw)
        losses = []
        for x, y in zip(xs, ys):
            if tag == "single":
                losses.append(float(step(x, y)))
            else:
                losses.append(float(step(x[lo:hi], y[lo:hi])))
        out[tag + ":loss"] = np.array(losses, np.float32)
        _state(step, net, tag, out)
        if tag != "single":
            # The state is the same on every rank: a replicated step.
            sd = step.state_dict()
            out[tag + ":rng_generators"] = len(sd["rng"]["generators"])
    np.savez(os.path.join(args.out, "trainstep_r%d.npz" % dist.rank()),
             **out)


def run_spmd_ring(args):
    """ring_self_attention's forward and gradients on the meshes of
    tests/test_ring_attention.py's shapes."""
    import importlib

    from mxnet_tpu_torch.parallel import dist, make_mesh

    # The package's ring_attention is the function; the module holds the
    # HOST_STAGED counter.
    ra = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")
    assert dist.initialize(backend="gloo", platform="cpu")
    data = np.load(args.data)
    out = {}
    axes = {"dp": 2, "sp": 2} if str(data["mesh"]) == "dp2sp2" \
        else {"sp": dist.num_processes()}
    mesh = make_mesh(axes)
    for causal in (False, True):
        q, k, v = (torch.tensor(data[n], requires_grad=True)
                   for n in ("q", "k", "v"))
        o = ra.ring_self_attention(mesh, q, k, v, causal=causal)
        gq, gk, gv = torch.autograd.grad((o ** 2).mean(), (q, k, v))
        tag = "c" if causal else "n"
        out[tag + ":out"] = o.detach().numpy()
        for name, g in (("gq", gq), ("gk", gk), ("gv", gv)):
            out["%s:%s" % (tag, name)] = g.numpy()
    out["host_staged"] = ra.HOST_STAGED
    np.savez(os.path.join(args.out, "ring_r%d.npz" % dist.rank()), **out)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--kv-type", default="dist_sync")
    parser.add_argument("--mode", default="kvstore",
                        choices=["kvstore", "failure", "trainer", "module",
                                 "overlap_compressed",
                                 "spmd_basic", "spmd_trainstep",
                                 "spmd_ring"])
    parser.add_argument("--data", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.mode.startswith("spmd_"):
        globals()["run_" + args.mode](args)
        return
    kv = mx.kv.create(args.kv_type)
    assert kv.type == args.kv_type, kv.type
    assert kv.num_workers == int(os.environ["DMLC_NUM_WORKER"])
    assert 0 <= kv.rank < kv.num_workers
    if args.mode == "failure":
        run_failure(kv)
    elif args.mode == "trainer":
        run_trainer(kv, args)
    elif args.mode == "module":
        run_module(kv, args)
    elif args.mode == "overlap_compressed":
        run_overlap_compressed(kv, args)
    elif args.kv_type == "dist_async":
        run_async(kv)
    else:
        run_sync(kv)
    kv.close()
    # A worker never initialises CUDA on the host path.
    assert not torch.cuda.is_initialized()


if __name__ == "__main__":
    main()
