"""Eager-dispatch overhead microbenchmark: op/s for a 10-op chain,
eager (op-by-op NDArray dispatch) against ``CachedOp``. One JSON line
per mode::

    python -m mxnet_tpu_torch.tools.dispatch_bench [--iters 200] [--size 256]
    MXNET_DEVICE=cpu python -m mxnet_tpu_torch.tools.dispatch_bench

Counterpart of the repo's ``tools/dispatch_bench.py``, with its JSON
keys, metric name and units. It runs on the context ``MXNET_DEVICE``
names (``auto|cpu|gpu``, ``util.pin_platform``'s values); unset, that
is the port's default, ``gpu(0)``, and a missing card raises. Each
timed loop ends by reading the result back (``.asnumpy()``), so the
window holds the card's work.

The port's ``CachedOp`` counts input signatures and runs its function
eagerly (``cached_op.py``): there is no compiled executable behind it
yet. Its row is the eager chain plus the CachedOp's own bookkeeping,
the figure a CUDA-graph capture of each signature has to beat.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_OPS = 10


def chain(nd, x):
    """A 10-op elementwise/matmul mix shaped like a small layer stack."""
    y = x
    y = nd.relu(y)           # 1
    y = y + 1.0              # 2
    y = y * 0.5              # 3
    y = nd.tanh(y)           # 4
    y = y - 0.1              # 5
    y = nd.sigmoid(y)        # 6
    y = y * y                # 7
    y = nd.exp(-y)           # 8
    y = y / 2.0              # 9
    return nd.sum(y)         # 10


def bench_eager(nd, x, iters):
    """Seconds for `iters` eager chains, and the last chain's output."""
    chain(nd, x).asnumpy()  # warm
    t0 = time.monotonic()
    for _ in range(iters):
        out = chain(nd, x)
    out.asnumpy()
    return time.monotonic() - t0, out


def bench_cached(nd, x, iters):
    """Seconds for `iters` calls of the chain as one CachedOp, and the
    last call's output."""
    from ..cached_op import CachedOp

    op = CachedOp(lambda a: chain(nd, a), num_params=0)
    op(x).asnumpy()  # warm: the signature's first call
    t0 = time.monotonic()
    for _ in range(iters):
        out = op(x)
    out.asnumpy()
    return time.monotonic() - t0, out


def run(iters=200, size=256, seed=0):
    """One row per mode: ``(mode, seconds, output)`` on the current
    context."""
    from .. import ndarray as nd

    x = nd.array(np.random.RandomState(seed).rand(size, size)
                 .astype(np.float32))
    return [(mode,) + fn(nd, x, iters)
            for mode, fn in (("eager", bench_eager),
                             ("cached_op", bench_cached))]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="op/s of a 10-op chain, eager against CachedOp")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args(argv)

    from .. import env
    from ..util import platform_context

    with platform_context(env.get("MXNET_DEVICE")):
        rows = run(args.iters, args.size)
    for mode, dt, _ in rows:
        print(json.dumps({
            "metric": "dispatch_op_per_s", "mode": mode,
            "value": round(args.iters * N_OPS / dt, 1), "unit": "op/s",
            "chain_ops": N_OPS, "iters": args.iters,
            "us_per_op": round(dt / (args.iters * N_OPS) * 1e6, 1)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
