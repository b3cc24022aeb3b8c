"""KVStore communication micro-benchmark::

    python -m mxnet_tpu_torch.tools.bandwidth.measure [--kv-store device]
    python -m mxnet_tpu_torch.tools.bandwidth.measure --kv-store dist_sync --num-servers 1
    python -m mxnet_tpu_torch.tools.bandwidth.measure --device cpu

Counterpart of the repo's ``tools/bandwidth/measure.py`` (reference:
tools/bandwidth/measure.py), with its table: it times push+pull rounds
over a kvstore for configurable array sizes and device counts and
reports the seconds a round and the implied bandwidth. A round ends by
reading back the first pulled element, the proof that it completed; only
that element crosses to the host (the JAX tool reads back the whole
array, which on a card times the device-to-host link too).

Devices: the arrays live on the current context, the port's default
``gpu(0)`` (``--device cpu``: the host). ``measure`` counts the cards
with ``torch.cuda.device_count()`` (the host is one device) and raises
when asked for more than exist, since the traffic would be same-device
copies; ``--num-devices`` defaults to what the machine has, at most 2.

``--kv-store dist*`` measures the multi-process parameter-server path:
a scheduler and ``--num-servers`` servers start as children (the
environment the port's ``parallel/launch.py`` gives its servers; they
never initialise CUDA), and this process is the one worker. Its arrays
on the card, a round includes the card<->host copies a ``dist_sync``
worker pays; ``--device cpu`` gives the host-only transport figure.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import subprocess
import sys
import time

_SERVER = ("import mxnet_tpu_torch.kvstore_server as s; "
           "s._init_kvstore_server_module()")
# Seconds the scheduler and servers get to end after the worker
# finalized, before they are killed.
_CHILD_EXIT_S = 60


def _first(arr):
    """The first element of `arr`, read back to the host: a 4-byte
    copy that waits for the work before it (reading back the whole
    array would time the device-to-host link, not the store)."""
    return float(arr[0:1].asnumpy()[0])


def _timed_rounds(round_trip, repeat, warmup, proof):
    """Mean seconds of `repeat` rounds after `warmup`; each timed
    round's completion proof goes to `proof` when given."""
    for _ in range(warmup):
        round_trip()
    t0 = time.perf_counter()
    for _ in range(repeat):
        value = round_trip()
        if proof is not None:
            proof.append(value)
    return (time.perf_counter() - t0) / repeat


def measure(kv_type="device", num_devices=None, sizes=(1024 * 1024,),
            repeat=5, warmup=2, proof=None):
    """Return [(size, avg_seconds, GB/s)] for push+pull rounds over
    `num_devices` devices of the current context's type (default: what
    exists, at most 2). Each timed round's first pulled element is
    appended to `proof` when given."""
    import torch

    from ... import kvstore, ndarray as nd
    from ...context import Context, current_context

    dev_type = current_context().device_type
    # The cards of this machine, or one host.
    avail = 1 if dev_type == "cpu" else torch.cuda.device_count()
    if num_devices is None:
        num_devices = min(avail, 2)
    if num_devices > avail:
        raise SystemExit(
            "requested %d devices but only %d %s device(s) exist — the "
            "measured traffic would be same-device copies"
            % (num_devices, avail, dev_type))
    kv = kvstore.create(kv_type)
    results = []
    ctxs = [Context(dev_type, i) for i in range(num_devices)]
    for size in sizes:
        key = "b%d" % size
        kv.init(key, nd.zeros((size,), ctx=ctxs[0]))
        vals = [nd.ones((size,), ctx=c) for c in ctxs]
        outs = [nd.zeros((size,), ctx=c) for c in ctxs]

        def round_trip():
            kv.push(key, vals)
            kv.pull(key, out=outs)
            return _first(outs[0])   # completion proof

        dt = _timed_rounds(round_trip, repeat, warmup, proof)
        # bytes moved per round: each device sends + receives the array
        gbs = (2 * num_devices * size * 4) / dt / 1e9
        results.append((size, dt, gbs))
    if hasattr(kv, "close"):
        kv.close()
    return results


@contextlib.contextmanager
def _environ(values):
    """`values` set in os.environ inside the block, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def dist_group(num_servers=2):
    """A local ``dist_sync`` group: a scheduler and `num_servers`
    servers started as children, and this process its one worker.
    Yields the worker's kvstore; at the end the store is closed and
    every child that has not ended is killed."""
    from ... import kvstore
    from ...parallel.launch import free_port

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    group = {"DMLC_PS_ROOT_URI": "127.0.0.1",
             "DMLC_PS_ROOT_PORT": str(free_port()),
             "DMLC_NUM_WORKER": "1",
             "DMLC_NUM_SERVER": str(num_servers)}
    procs = []
    try:
        for role in ["scheduler"] + ["server"] * num_servers:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SERVER],
                env=dict(os.environ, DMLC_ROLE=role, **group), cwd=root,
                start_new_session=True))
        with _environ(dict(group, DMLC_ROLE="worker")):
            kv = kvstore.create("dist_sync")
        try:
            yield kv
        finally:
            kv.close()
        # The scheduler ends the group once the worker has finalized.
        deadline = time.monotonic() + _CHILD_EXIT_S
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def dist_rounds(kv, sizes=(1024 * 1024,), repeat=5, warmup=2, ctx=None,
                proof=None, prefix="b"):
    """[(size, avg_seconds, GB/s)] of push+pull rounds of the worker's
    store `kv`, its arrays on `ctx` (default: the current context),
    under keys ``<prefix><size>``."""
    from ... import ndarray as nd

    results = []
    for size in sizes:
        key = "%s%d" % (prefix, size)
        kv.init(key, nd.zeros((size,), ctx=ctx))
        val = nd.ones((size,), ctx=ctx)
        out = nd.zeros((size,), ctx=ctx)

        def round_trip():
            kv.push(key, val)
            kv.pull(key, out=out)
            return _first(out)   # completion proof

        dt = _timed_rounds(round_trip, repeat, warmup, proof)
        gbs = (2 * size * 4) / dt / 1e9   # pushed + pulled bytes
        results.append((size, dt, gbs))
    return results


def measure_dist(sizes=(1024 * 1024,), repeat=5, warmup=2,
                 num_servers=2, proof=None):
    """Bandwidth of the multi-process parameter-server path: this
    process the one worker of a :func:`dist_group`, its arrays on the
    current context. Returns [(size, avg_seconds, GB/s)]; each timed
    round's first pulled element goes to `proof` when given."""
    with dist_group(num_servers) as kv:
        return dist_rounds(kv, sizes, repeat, warmup, proof=proof)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="measure kvstore communication cost",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--kv-store", default="device",
                        help="device/local, or dist for the "
                        "multi-process parameter-server path")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="devices of the current context's type "
                        "(default: what exists, at most 2)")
    parser.add_argument("--num-servers", type=int, default=2)
    parser.add_argument("--sizes", default="262144,1048576,4194304",
                        help="comma-separated float32 element counts")
    parser.add_argument("--repeat", type=int, default=5)
    parser.add_argument("--device", default="auto",
                        choices=["auto", "cpu", "gpu"])
    args = parser.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]

    from ...util import platform_context

    with platform_context(args.device):
        if args.kv_store.startswith("dist"):
            rows = measure_dist(sizes, args.repeat,
                                num_servers=args.num_servers)
        else:
            rows = measure(args.kv_store, args.num_devices, sizes,
                           args.repeat)
    print("%12s %12s %10s" % ("elements", "sec/round", "GB/s"))
    for size, dt, gbs in rows:
        print("%12d %12.6f %10.3f" % (size, dt, gbs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
