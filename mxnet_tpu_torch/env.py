"""Runtime configuration knob catalogue.

Counterpart of ``mxnet_tpu/env.py`` (reference: docs/faq/env_var.md):
one table of the ``MXNET_*`` knobs this package reads, with type,
default and where each acts; :func:`get` reads a knob with its type and
:func:`describe` renders the table. The port keeps only the knobs its
modules read.
"""
from __future__ import annotations

import os
from collections import namedtuple

__all__ = ["CATALOGUE", "get", "describe"]

Knob = namedtuple("Knob", "name typ default where doc subsumed")

CATALOGUE = [
    Knob("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice", "engine.py",
         "NaiveEngine = serial debug oracle (synchronize after every "
         "fused apply); default = torch's asynchronous CUDA dispatch",
         False),
    Knob("MXNET_SUBGRAPH_BACKEND", str, "", "executor.py",
         "auto-partition bound graphs with this registered subgraph "
         "backend (reference build_subgraph pass)", False),
    Knob("MXNET_FUSED_UPDATE", bool, True, "gluon/trainer.py",
         "imperative fused update path: multi-tensor optimizer apply "
         "(per-Trainer override: fused=False)", False),
    Knob("MXNET_FUSED_BUCKET_MB", int, 25, "fused_update.py",
         "size of one fused-apply chunk of a (device, dtype) group",
         False),
    Knob("MXNET_FUSED_OVERLAP_DEPTH", int, 2, "gluon/trainer.py",
         "comm/compute overlap window of the multi-context or dist fused "
         "step (0 = serial; a single-context Trainer reduces nothing and "
         "ignores it)", False),
    Knob("MXNET_FUSED_DONATE", str, "auto", "fused_update.py",
         "accepted for scripts of the JAX package: the port's fused "
         "apply updates its flat buffers in place, so there is nothing "
         "to donate", True),
    Knob("MXNET_MP_LOWP_DTYPES", str, "float16,bfloat16", "optimizer.py",
         "low-precision weight dtypes that keep an fp32 master copy "
         "when multi_precision=True", False),
    Knob("MXNET_WORKER_START_METHOD", str, "fork",
         "gluon/data/dataloader.py",
         "DataLoader worker start method: fork | forkserver | spawn",
         False),
    Knob("MXNET_DATA_MAX_WORKERS", int, 16, "data/autoscale.py",
         "decode-pool autoscaling ceiling: DecodeAutoscaler never grows "
         "a pool past this many workers", False),
    Knob("MXNET_USE_NATIVE_RECORDIO", int, 1, "recordio.py",
         "0 forces the pure-python RecordIO path (escape hatch; re-read "
         "on every read so a mid-run flip takes effect)", False),
    Knob("MXNET_TPU_MODEL_ZOO_DIR", str, "", "gluon/model_zoo/",
         "local directory of pretrained model zoo params (no-download "
         "model store)", False),
    Knob("MXNET_DEVICE", str, "", "tools/",
         "device of a tool's run: auto | cpu | gpu (util.pin_platform's "
         "values). Unset or auto = the current context, the port's "
         "default gpu(0); cpu runs on the host", False),
    Knob("MXNET_PROFILE_HZ", float, 67.0, "telemetry/profiling.py",
         "continuous-profiler stack sampling rate (Hz); non-round so "
         "loops don't alias with the sampler", False),
    Knob("MXNET_PROFILE_WINDOW_S", float, 30.0, "telemetry/profiling.py",
         "continuous-profiler window length; each window closes one "
         "collapsed-stack profile into the retention ring", False),
    Knob("MXNET_PROFILE_RETAIN", int, 20, "telemetry/profiling.py",
         "profile windows retained (ring; /debug/pprof?seconds=N can "
         "reach back window_s * retain seconds)", False),
    Knob("MXNET_XPROF_DIR", str, "", "telemetry/healthplane.py",
         "capture root for POST /debug/xprof (torch.profiler chrome "
         "traces); default: <recorder dir>/xprof when a FlightRecorder "
         "is attached to the health plane", False),
    Knob("MXNET_GOODPUT_DIR", str, "", "telemetry/goodput.py",
         "goodput ledger root: goodput.rank<R>.json is committed here "
         "atomically and resumed after a restart; empty = in-memory "
         "accounting only (no durability, no restart_replay)", False),
    Knob("MXNET_GOODPUT_INTERVAL_S", float, 30.0,
         "telemetry/goodput.py",
         "goodput ledger tick cadence: fold + durable commit at most "
         "this often (0 = every tick)", False),
    Knob("MXNET_GOODPUT_CLOSURE_PCT", float, 2.0,
         "telemetry/goodput.py",
         "goodput closure tolerance: snapshots whose categories "
         "overcount wall-clock by more than this percentage warn and "
         "report closure_ok=false", False),
    Knob("MXNET_GATEWAY_MAX_QUEUE", int, 256, "serving/gateway.py",
         "inference gateway: TOTAL queued requests across all "
         "registered models (one bounded admission pool); past it "
         "submit() raises QueueFullError", False),
    Knob("MXNET_GATEWAY_SHED_BURN_RATE", float, 14.4, "serving/gateway.py",
         "inference gateway: SLO burn rate at which a model's "
         "admission starts shedding its LOWEST deadline class "
         "(503) instead of letting p99 collapse for everyone", False),
    Knob("MXNET_GATEWAY_DRAIN_TIMEOUT_S", float, 30.0,
         "serving/gateway.py",
         "hot reload: how long swap_backend waits for in-flight "
         "batches of the old generation to drain before returning "
         "with the old backend still referenced", False),
    Knob("MXNET_DECODE_PAGE_SLOTS", int, 8, "serving/continuous.py",
         "continuous batching: batch slots per state page (the paged "
         "per-slot state granularity; a step covers whole pages, so "
         "smaller pages track occupancy tighter at more step "
         "signatures)", False),
    Knob("MXNET_DECODE_MAX_TOKENS", int, 128, "serving/continuous.py",
         "continuous batching: default generation cap per sequence "
         "(submit_sequence(max_tokens=) overrides per request)", False),
    Knob("MXNET_DECODE_IDLE_POLL_MS", float, 20.0,
         "serving/continuous.py",
         "continuous batching: DecodeLoop idle wait between wakeup "
         "checks when no slot is occupied and nothing is queued "
         "(enqueues notify immediately; this only bounds the fallback "
         "poll)", False),
    Knob("MXNET_TRACE_SAMPLE", float, 1.0, "telemetry/xtrace.py",
         "head-based trace sampling probability in [0, 1], decided once "
         "per root context", False),
    Knob("MXNET_KVSTORE_BIGARRAY_BOUND", int, 1000000, "kvstore_dist.py",
         "dist kvstore: arrays >= this many elements shard across all "
         "servers", False),
    Knob("MXNET_KVSTORE_DEBUG", int, 0, "kvstore_server.py",
         "verbose parameter-server tracing", False),
    Knob("MXNET_PS_SNAPSHOT_DIR", str, "", "kvstore_server.py",
         "server recovery: per-key shard snapshots live here", False),
    Knob("MXNET_PS_SNAPSHOT_EVERY", int, 1, "kvstore_server.py",
         "applies between optimizer-state meta snapshots", False),
    Knob("MXNET_TPU_PS_TIMEOUT", float, 300.0, "kvstore_server.py",
         "dist rendezvous/barrier timeout in seconds", False),
    Knob("MXNET_TPU_PS_AUTHKEY", str, "mxnet_tpu_kvstore",
         "kvstore_server.py", "dist transport auth key", False),
    Knob("MXNET_TRACE_DIR", str, "", "kvstore_server.py",
         "when set, kvstore server processes stream their trace "
         "segments here (trace.rank<R>.<seq>.jsonl, server ranks "
         "numbered past the workers)", False),
    Knob("MXNET_COMPILE_CACHE", str, "", "compile/",
         "persistent compile-cache directory (empty = disabled): a "
         "process loads the kernel libraries nvcc built and the cubins "
         "NVRTC compiled instead of compiling them again", False),
    Knob("MXNET_COMPILE_CACHE_MB", int, 2048, "compile/store.py",
         "compile-cache retention budget; oldest-by-mtime entries are "
         "retired past it (hits re-touch their entry)", False),
    Knob("MXNET_COMPILE_CACHE_SHARED", bool, False, "compile/",
         "every rank's MXNET_COMPILE_CACHE points at ONE shared "
         "directory: skip the kvstore cc_* distribution channel "
         "(entries commit atomically, so concurrent ranks are safe)",
         False),
    Knob("MXNET_PS_CC_ENTRY_MB", int, 64, "compile/distribute.py",
         "largest compile-cache entry distributed over the kvstore; "
         "bigger entries stay local-only", False),
    Knob("MXNET_PS_CC_BUFFER_MB", int, 256, "kvstore_server.py",
         "kvstore server's compile-cache buffer bound (total bytes, "
         "drop-oldest)", False),
    Knob("MXNET_TPU_PS_HEARTBEAT", float, 5.0, "kvstore_dist.py",
         "worker->scheduler liveness ping interval in seconds (feeds "
         "get_dead_nodes)", False),
    Knob("MXNET_PS_RECONNECT_TIMEOUT", float, 120.0, "kvstore_dist.py",
         "how long a worker re-queries the scheduler for a restarted "
         "server's new address before giving up", False),
    Knob("MXNET_PS_DIAG_BUFFER", int, 16, "kvstore_server.py",
         "kvstore server's flight-recorder bundle buffer bound (bundles "
         "per rank, drop-oldest)", False),
    Knob("DMLC_ROLE", str, "worker", "kvstore_server.py",
         "process role: worker | server | scheduler (set by "
         "parallel/launch.py)", False),
    Knob("DMLC_PS_ROOT_URI", str, "127.0.0.1", "kvstore_server.py",
         "scheduler host (the process group's rendezvous host when "
         "-s 0)", False),
    Knob("DMLC_PS_ROOT_PORT", int, 9091, "kvstore_server.py",
         "scheduler port (the process group's rendezvous port when "
         "-s 0)", False),
    Knob("DMLC_NUM_WORKER", int, 1, "kvstore_server.py",
         "worker count of the dist group", False),
    Knob("DMLC_NUM_SERVER", int, 1, "kvstore_server.py",
         "server count of the dist group", False),
    Knob("DMLC_NODE_HOST", str, "127.0.0.1", "kvstore_server.py",
         "address this server advertises to the scheduler", False),
    Knob("DMLC_WORKER_ID", int, 0, "parallel/dist.py",
         "this process's worker rank (set by parallel/launch.py)", False),
    Knob("DMLC_WORKER_RECOVERY", str, "", "kvstore_dist.py",
         "set on a restarted worker: rejoin the group as this rank "
         "instead of rendezvousing fresh", False),
    Knob("DMLC_SERVER_RECOVERY", str, "", "kvstore_server.py",
         "set on a restarted server: reload per-key snapshots and "
         "re-announce through the scheduler", False),
]

_BY_NAME = {k.name: k for k in CATALOGUE}


def get(name, default=None):
    """Read a catalogued knob with its declared type."""
    k = _BY_NAME.get(name)
    if k is None:
        return os.environ.get(name, default)
    raw = os.environ.get(name)
    if raw is None:
        return k.default if default is None else default
    if k.typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return k.typ(raw)


def describe():
    """Render the catalogue (reference env_var.md as a runtime table)."""
    lines = ["%-34s %-10s %-22s %s" % ("Name", "Type", "Default", "Doc")]
    for k in CATALOGUE:
        doc = k.doc + (" [subsumed]" if k.subsumed else "")
        lines.append("%-34s %-10s %-22s %s"
                     % (k.name, k.typ.__name__, str(k.default), doc))
    return "\n".join(lines)
