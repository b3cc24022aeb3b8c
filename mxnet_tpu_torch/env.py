"""Runtime configuration knob catalogue.

Counterpart of ``mxnet_tpu/env.py`` (reference: docs/faq/env_var.md):
one table of the ``MXNET_*`` knobs this package reads, with type,
default and where each acts; :func:`get` reads a knob with its type and
:func:`describe` renders the table. The port keeps only the knobs its
modules read; the JAX package's kvstore-server, gateway, compile-cache
and dist knobs come with the modules that read them (ROADMAP Queue 1).
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
         "comm/compute overlap window of the multi-context fused step "
         "(ROADMAP Queue 1 item 7; a single-context Trainer reduces "
         "nothing and ignores it)", False),
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
    Knob("MXNET_TRACE_SAMPLE", float, 1.0, "telemetry/xtrace.py",
         "head-based trace sampling probability in [0, 1], decided once "
         "per root context", False),
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
