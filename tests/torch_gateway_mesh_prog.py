"""Rank program of the port's mesh-sharded gateway test
(tests/test_torch_serving_gateway.py).

Launched by ``mxnet_tpu_torch.parallel.launch`` as an SPMD group of two
ranks over gloo on the host (``torch_dist_prog.launch(2, 0, "mesh", out,
prog=PROG)``). Each rank runs a ``ModelGateway`` with one model, a
two-layer MLP registered with ``mesh_axes={"tp": 2}``: each rank holds
its block of both weight matrices, and every call gathers them. The
ranks drive the same request schedule in lockstep (each call's gather is
a collective) and write, per request, the gateway's output, the bucket
it ran in and the unsharded port model's output on the same padded
batch; plus the backend's ``compile_count``, the bytes it holds and the
error a mesh of the wrong size raises (``mesh_r<rank>.npz``).
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
MESH_PARAMS = {"in": 12, "hidden": 16, "out": 6}
ROWS = (1, 3, 8, 5, 2, 8)           # the lockstep schedule's request rows


def mlp_params(seed=0):
    """[w1, b1, w2, b2] of the MLP, float32 numpy."""
    rng = np.random.default_rng(seed)
    p = MESH_PARAMS
    return [rng.standard_normal((p["hidden"], p["in"]), np.float32) * 0.5,
            rng.standard_normal(p["hidden"], np.float32) * 0.1,
            rng.standard_normal((p["out"], p["hidden"]), np.float32) * 0.5,
            rng.standard_normal(p["out"], np.float32) * 0.1]


def mlp(pkg):
    """fn(w1, b1, w2, b2, x) over `pkg`'s nd ops."""
    nd = pkg.nd

    def fn(w1, b1, w2, b2, x):
        h = nd.relu(nd.FullyConnected(x, w1, b1,
                                      num_hidden=MESH_PARAMS["hidden"]))
        return nd.FullyConnected(h, w2, b2, num_hidden=MESH_PARAMS["out"])

    return fn


def run_mesh(out_dir):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel import dist

    assert dist.initialize(backend="gloo", platform="cpu")
    ctx = mx.cpu()
    params = [mx.nd.array(p, ctx=ctx) for p in mlp_params()]
    out = {}
    try:
        serving.MeshShardedModel(mlp(mx), params, {"tp": 4}, ctx=ctx)
    except ValueError as exc:
        out["refused"] = str(exc)
    gw = serving.ModelGateway(ctx=ctx, max_delay_ms=1.0)
    try:
        gw.register(serving.ModelSpec(
            "mesh", fn=mlp(mx), params=params,
            item_shape=(MESH_PARAMS["in"],), max_batch=8,
            mesh_axes={"tp": 2}))
        backend = gw._state("mesh").backend
        policy = gw.registry.spec("mesh").policy
        plain = serving.engine._FnModel(mlp(mx), params, ctx=ctx)
        rng = np.random.default_rng(11)
        for i, k in enumerate(ROWS):
            x = rng.standard_normal((k, MESH_PARAMS["in"]), np.float32)
            y = gw.predict("mesh", x).output.asnumpy()
            bucket = policy.bucket_for(k)
            padded = np.zeros((bucket, MESH_PARAMS["in"]), np.float32)
            padded[:k] = x
            unsharded = plain(mx.nd.array(padded, ctx=ctx)).asnumpy()[:k]
            out.update({"x%d" % i: x, "y%d" % i: y, "u%d" % i: unsharded,
                        "bucket%d" % i: bucket})
        out["n"] = len(ROWS)
        out["compile_count"] = backend.compile_count
        out["held"] = backend.held_bytes
    finally:
        gw.shutdown()
    np.savez(os.path.join(out_dir, "mesh_r%d.npz" % dist.rank()), **out)
    dist.barrier()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    if args.mode != "mesh":
        raise SystemExit("unknown mode %r" % args.mode)
    run_mesh(args.out)


if __name__ == "__main__":
    main()
