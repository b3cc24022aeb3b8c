#!/usr/bin/env python
"""Observability end to end: a TrainStep loop wired into
``mxnet_tpu_torch.telemetry`` — unified metrics, chrome-trace spans, and
the step-health monitor.

Counterpart of ``examples/train_telemetry.py``, driving the port. What
it shows:

1. ``callback.TelemetryCallback`` — the Speedometer-shaped batch-end
   callback that feeds ``mx_train_batch_seconds`` /
   ``mx_train_samples_total`` and a ``telemetry.StepMonitor``,
2. ``StepMonitor`` — slow-step EWMA outliers, recompile detection via
   ``CachedOp.on_trace``, checkpoint-writer backlog (all warn
   rate-limited through ``mxnet_tpu_torch.log`` and count into
   ``mx_anomalies_total``),
3. async ``checkpoint.CheckpointManager`` saves whose ``checkpoint::*``
   counters land in the SAME registry,
4. **streaming span export** — a ``StreamingTraceWriter`` drains the
   trace rings incrementally into atomically committed
   ``trace.rank0.*.jsonl`` segments, and the repository's
   ``tools/trace_merge.py`` (which imports no framework) stitches them
   into the final chrome_trace.json loadable in Perfetto,
5. **pod-style aggregation** — an ``Aggregator`` over a ``LocalBus``
   endpoint shows the fleet view: the final scrape carries every series
   labeled by rank (here rank 0) plus the staleness gauges,
6. **SLO burn rate** — a ``BurnRateMonitor`` over
   ``mx_train_step_seconds`` emits ``mx_slo_burn_rate{slo,window}``,
7. **flamegraph** — ``profiler.dumps(format="top")`` self-time table and
   a collapsed-stack file for flamegraph.pl / speedscope,
8. ``telemetry.render_prometheus()`` — and, with ``--metrics-port``, a
   live stdlib ``/metrics`` endpoint to curl while it trains.

Runs on ``gpu(0)`` unless ``--cpu`` is given::

    python -m mxnet_tpu_torch.examples.train_telemetry --num-batches 40
    python -m mxnet_tpu_torch.examples.train_telemetry --metrics-port 9090
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics on this port (0 = off)")
    ap.add_argument("--out-dir", default=None,
                    help="where chrome_trace.json + checkpoints land "
                         "(default: a temp dir)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host instead of gpu(0)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, gluon, model, telemetry
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="telemetry_demo_")
    os.makedirs(out_dir, exist_ok=True)

    server = None
    if args.metrics_port:
        server = telemetry.start_http_server(args.metrics_port)
        print("metrics: http://%s:%d/metrics" % server.server_address[:2])

    # -- model + step ---------------------------------------------------------
    mx.random.seed(42)
    rng = np.random.RandomState(42)
    net = gluon.nn.HybridSequential(prefix="tele_")
    net.add(gluon.nn.Dense(256, activation="relu", in_units=784,
                           prefix="fc1_"))
    net.add(gluon.nn.Dense(10, in_units=256, prefix="fc2_"))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd",
                     optimizer_params={"learning_rate": 0.05,
                                       "momentum": 0.9},
                     mesh=make_mesh({"dp": 1}, devices=[ctx]))

    # -- telemetry wiring -----------------------------------------------------
    monitor = telemetry.StepMonitor(slow_factor=3.0, warmup_steps=3)
    # Streaming export: spans hit disk incrementally (age budget keeps
    # an observer at most 5s behind), committed atomically per segment.
    writer = telemetry.StreamingTraceWriter(
        os.path.join(out_dir, "trace_segments"), max_segment_age_s=5.0)
    # Pod-style aggregation, single-process edition: a LocalBus stands
    # in for the kvstore channel; the fleet scrape labels every series
    # with its rank. On a real dist job pass the KVStoreDist instead.
    bus = telemetry.aggregate.LocalBus(num_workers=1)
    aggregator = telemetry.Aggregator(bus.endpoint(0), interval_s=2.0,
                                      monitor=monitor)
    # SLO: 95% of steps under 2s — generous on purpose; the burn-rate
    # gauges still show the machinery live.
    burn = telemetry.BurnRateMonitor(eval_interval_s=1.0)
    burn.add_latency_slo("train_step", 0.95, 2.0, "mx_train_step_seconds")
    cb = callback.TelemetryCallback(args.batch_size, frequent=10,
                                    monitor=monitor, trace_writer=writer,
                                    aggregator=aggregator, slo=burn)
    manager = CheckpointManager(os.path.join(out_dir, "ckpt"),
                                keep_last=2)
    monitor.watch_checkpoint(manager)

    steps_before = telemetry.REGISTRY.get("mx_train_steps_total").value
    x = rng.rand(args.batch_size, 784).astype(np.float32)
    y = rng.randint(0, 10, args.batch_size)
    loss = None
    for i in range(args.num_batches):
        loss = step(x, y)
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            manager.save(i + 1, step.state_dict())     # async commit
        cb(model.BatchEndParam(epoch=0, nbatch=i, eval_metric=None,
                               locals=None))
    final_loss = float(loss)
    manager.close()
    burn.evaluate()
    aggregator.close()          # final push: fleet view is current
    writer.close()              # final segment commit

    # -- merge + report -------------------------------------------------------
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import trace_merge

    trace_path = os.path.join(out_dir, "chrome_trace.json")
    merged = trace_merge.merge([os.path.join(out_dir, "trace_segments")],
                               out=trace_path)
    flame_path = telemetry.flamegraph.dump_collapsed(
        os.path.join(out_dir, "flame.collapsed"), merged)

    text = aggregator.render_prometheus()       # the fleet view
    interesting = [line for line in text.splitlines()
                   if line.startswith(("mx_train_steps_total",
                                       "mx_train_samples_total",
                                       "mx_train_step_seconds_count",
                                       "mx_cachedop_compiles_total",
                                       "mx_anomalies_total",
                                       "mx_slo_burn_rate",
                                       "mx_rank_stale"))
                   or 'name="checkpoint::' in line]
    print("\n".join(interesting))
    print("step-health: %s" % monitor.snapshot())
    print(mx.profiler.dumps(format="top"))
    print("chrome trace: %s (load in Perfetto / chrome://tracing); "
          "%d streamed segments; collapsed stacks: %s"
          % (trace_path, len(writer.committed), flame_path))
    print("final loss %.4f" % final_loss)

    steps = telemetry.REGISTRY.get("mx_train_steps_total").value - \
        steps_before
    ok = (steps >= args.num_batches
          and os.path.getsize(trace_path) > 0
          and len(writer.committed) >= 1
          and 'rank="0"' in text
          and "mx_train_step_seconds_count" in text)
    if server is not None:
        server.close()
    print("telemetry demo %s" % ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
