"""``chip_smoke.py`` phase 28 ("tools") and phase 22's tool part,
rehearsed on the host.

Phase 28 runs with its card calls patched (``mx.gpu``/``context.gpu``
give ``cpu(0)``, ``torch.cuda.synchronize`` does nothing,
``Tensor.cuda`` stays on the host) inside ``with mx.cpu():``, at
shrunken sizes (``TOOLS``), its dist group's scheduler and server real
children. ``check`` records instead of raising: the one check that
fails on the host by construction is the int8 GEMM count (the host
contracts in float64, ``torch._int_mm`` runs on a card only).

Phase 22's part 5 (``_tele_tools``) runs, its checks raising, over a
directory laid out as parts 1 and 2 leave it: two bundles of the port's
``FlightRecorder`` (their env and memory entries as a card process
writes them), a ``GoodputLedger`` file and two collapsed captures of the
port's ``dump_collapsed``; a bundle that does not name the card fails
it.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import flamegraph, trace

torch.set_num_threads(2)

CARD = "NVIDIA H100 80GB HBM3"


def test_phase_28_rehearses_on_the_host(monkeypatch):
    import chip_smoke

    failed, lines = [], []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a))
    monkeypatch.setattr(mx, "gpu", lambda i=0: mx.cpu(0))
    monkeypatch.setattr(mx.context, "gpu", lambda i=0: mx.cpu(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.delenv("MXNET_DEVICE", raising=False)
    monkeypatch.setattr(chip_smoke, "TOOLS", {
        "dispatch": {"iters": 3, "size": 16},
        "quantized": {"batch": 2, "channels": 8, "iters": 1},
        "decode": {"n": 8, "size": 32, "batch": 4, "batches": 2,
                   "threads": (0, 2)},
        "kv_sizes": (1024, 4096), "kv_repeat": 1, "dist_servers": 1})
    with mx.cpu():
        reads = chip_smoke.phase_tools("host, rehearsal")
    assert failed == ["quantized_bench ran no int8 GEMM on the card"], failed
    assert sorted(reads) == ["tools_bandwidth", "tools_decode",
                             "tools_dispatch", "tools_quantized"]
    for launches in reads.values():
        assert launches["k1_k2_k3"] == (0, 0, 0)
        assert not any(launches["d1_d2"])
    readings = {}
    for parts in lines:
        if parts and isinstance(parts[0], str) and '"reading"' in parts[0]:
            row = json.loads(parts[0])
            readings[row["reading"]] = row[row["reading"]]
    dp = readings["tools_dispatch"]
    assert dp["sums_bit_for_bit"] and len(dp["rows"]) == 2
    qt = readings["tools_quantized"]
    for row in qt["parity"].values():
        assert row["max_abs_err"] == 0.0 and row["limit"] > 0
    dc = readings["tools_decode"]
    assert dc["batches"] == 4 and dc["batch_contexts"] == ["cpu(0)"]
    assert dc["host_has_cv2"] == ("jpeg_resize_img_s" in dc)
    bw = readings["tools_bandwidth"]
    for tag in ("device", "dist_gpu", "dist_cpu"):
        assert [r[0] for r in bw[tag]] == [1024, 4096]
        assert bw[tag + "_proof"] == [1.0]


def _phase22_files(tmp):
    """What phase 22's parts 1 and 2 leave in `tmp` for part 5."""
    diag = os.path.join(tmp, "diag")
    os.makedirs(diag)
    mon = telemetry.StepMonitor(warn_interval_s=1e9)
    rec = telemetry.FlightRecorder(diag, rank=0, rate_limit_s=0.0)
    rec.attach(mon)
    rec.capture("manual", "POST /debug/bundle")
    guard = telemetry.NumericGuard(monitor=mon, every=1)
    guard.observe_batch(step=3, batch_ids=[0, 1])
    guard.check_loss(float("nan"))
    for k, path in enumerate(rec.bundles):
        with open(path) as f:
            bundle = json.load(f)
        bundle["env"].update(cuda="12.8", device=CARD)
        bundle["device_memory"] = {"cuda:0": {
            "buffers": None if k else 1234, "bytes": 2 ** 30 + k,
            "peak_bytes": 2 ** 31, "limit_bytes": 85 * 10 ** 9}}
        with open(path, "w") as f:
            json.dump(bundle, f)
    os.makedirs(os.path.join(tmp, "goodput"))
    clock = [0.0]
    ledger = telemetry.GoodputLedger(os.path.join(tmp, "goodput"), rank=0,
                                     interval_s=0.0,
                                     registry=telemetry.metrics.Registry(),
                                     clock=lambda: clock[0])
    rng = np.random.RandomState(0)
    for step in range(1, 5):
        secs = float(rng.uniform(0.05, 0.1))
        clock[0] += secs + 0.01
        ledger.observe_step(step, secs)
        ledger.tick(step)
    ledger.close()
    import chip_smoke

    for name, ops in zip(chip_smoke.TELE_CAPTURES,
                         (("conv", "bn", "relu"), ("attention", "dense"))):
        trace.clear()
        t = 10.0
        for _ in range(3):
            trace.complete("train_step", t, t + 0.02)
            inner = t + 0.001
            for op in ops:
                d = float(rng.uniform(0.001, 0.004))
                trace.complete(op, inner, inner + d)
                inner += d + 0.0002
            t += 0.021
        flamegraph.dump_collapsed(os.path.join(tmp, name))
    trace.clear()
    return rec.bundles


def test_phase_22_tools_part_rehearses_on_the_host(monkeypatch, tmp_path):
    import chip_smoke

    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: CARD)
    bundles = _phase22_files(str(tmp_path))
    line = chip_smoke._tele_tools("host, rehearsal", str(tmp_path))
    assert len(line["bundles"]) == len(bundles) == 2
    assert all(", device %s," % CARD in row for row in line["diagnose_env"])
    assert line["diagnose_memory"] == ["device cuda:0: 1.0GB live"] * 2
    assert line["merged_self_us"] == sum(line["capture_self_us"]) > 0
    assert all(d == 0.0 for d in line["compare_deltas_pp"])
    assert all(0 < v <= 100.1 for v in line["top_share_sum"].values())
    # A bundle that does not name the card fails the part.
    with open(bundles[0]) as f:
        bundle = json.load(f)
    bundle["env"].pop("device")
    with open(bundles[0], "w") as f:
        json.dump(bundle, f)
    with pytest.raises(chip_smoke.SmokeError, match="do not name"):
        chip_smoke._tele_tools("host, rehearsal", str(tmp_path))
