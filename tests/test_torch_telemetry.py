"""The port's telemetry modules against the JAX package's.

The same inputs go through ``mxnet_tpu.telemetry`` and
``mxnet_tpu_torch.telemetry``: registries built alike (fresh
``Registry`` objects, never the process-wide ones), the same spans, the
same step-time series and event timeline on a fixed clock. Outputs are
held equal exactly: the remote-write bytes, the merged fleet registry's
snapshot and Prometheus text, the burn-rate gauges, the collapsed
stacks, the StepMonitor's anomalies and the goodput ledger's snapshot
(its wall-clock stamp ``updated_unix`` left out).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu.telemetry as jtel
from mxnet_tpu.telemetry import aggregate as jagg
from mxnet_tpu.telemetry import flamegraph as jflame
from mxnet_tpu.telemetry import goodput as jgood
from mxnet_tpu.telemetry import health as jhealth
from mxnet_tpu.telemetry import remote_write as jrw
from mxnet_tpu.telemetry import slo as jslo

import mxnet_tpu_torch.telemetry as tel
from mxnet_tpu_torch.telemetry import aggregate as agg
from mxnet_tpu_torch.telemetry import flamegraph as flame
from mxnet_tpu_torch.telemetry import goodput as good
from mxnet_tpu_torch.telemetry import health as health
from mxnet_tpu_torch.telemetry import remote_write as rw
from mxnet_tpu_torch.telemetry import slo as slo

torch.set_num_threads(2)

PACKAGES = {"jax": (jtel, jagg, jflame, jgood, jhealth, jrw, jslo),
            "port": (tel, agg, flame, good, health, rw, slo)}


class Clock:
    """A fixed clock the test advances."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _fill(telemetry, seed):
    """A registry of every kind, filled from `seed`'s numbers."""
    rng = np.random.RandomState(seed)
    reg = telemetry.Registry()
    c = reg.counter("mx_demo_total", "demo counter", labels=("op",))
    g = reg.gauge("mx_demo_gauge", "demo gauge", labels=("device",))
    h = reg.histogram("mx_demo_seconds", "demo latency", labels=("site",))
    for op in ("conv", "dense", "relu"):
        c.labels(op=op).inc(int(rng.randint(1, 50)))
    for dev in ("cuda:0", "cpu"):
        g.labels(device=dev).set(float(rng.rand() * 1e6))
    for site in ("train_step", "cached_op"):
        for v in rng.exponential(0.05, size=20):
            h.labels(site=site).observe(float(v))
    reg.counter("mx_plain_total", "no labels").inc(3)
    return reg


def test_remote_write_bytes_are_the_jax_packages():
    out = {}
    for name, (telemetry, _, _, _, _, remote, _) in PACKAGES.items():
        reg = _fill(telemetry, 7)
        out[name] = (remote.encode_write_request(
                         reg, 1_700_000_000_000, {"job": "train"},
                         compress=False),
                     remote.encode_write_request(reg, 1_700_000_000_000))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) > 500


def test_push_exporter_speaks_remote_write_as_the_jax_package(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = {}
    for name, (telemetry, *_rest) in PACKAGES.items():
        ex = telemetry.PushExporter("http://127.0.0.1:1/api/v1/write",
                                    registry=_fill(telemetry, 3),
                                    job="train", instance="rank0",
                                    wire_format="remote_write")
        out[name] = ex._render()
    assert out["port"] == out["jax"]
    assert out["port"][1] == dict(rw.CONTENT_HEADERS)


@pytest.mark.parametrize("merged_rank", ["all", None])
def test_merge_snapshots_and_its_text_are_the_jax_packages(merged_rank):
    out = {}
    for name, (telemetry, aggregate, *_rest) in PACKAGES.items():
        snaps = {r: aggregate.snapshot_registry(_fill(telemetry, 10 + r))
                 for r in range(3)}
        fleet = aggregate.merge_snapshots(snaps, merged_rank=merged_rank)
        out[name] = (snaps, aggregate.snapshot_registry(fleet),
                     fleet.render_prometheus())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    assert 'rank="2"' in out["port"][2]


def test_aggregator_over_a_local_bus_is_the_jax_packages():
    out = {}
    for name, (telemetry, aggregate, *_rest) in PACKAGES.items():
        clock = Clock()
        bus = aggregate.LocalBus(num_workers=2)
        regs = [_fill(telemetry, 20 + r) for r in range(2)]
        aggs = [aggregate.Aggregator(bus.endpoint(r), registry=regs[r],
                                     interval_s=0.0, stale_after_s=30.0,
                                     clock=clock) for r in range(2)]
        aggs[1].step()
        aggs[0].step()
        # The bus stamps its receipts on the real monotonic clock: the
        # report ages are readings, the rest is the merge.
        out[name] = [line for line in
                     aggs[0].render_prometheus().splitlines()
                     if not line.startswith(
                         "mx_rank_last_report_age_seconds{")]
    assert out["port"] == out["jax"]
    assert 'mx_rank_stale{rank="1"} 0' in out["port"]


def test_burn_rate_gauges_are_the_jax_packages():
    rng = np.random.RandomState(5)
    samples = [rng.exponential(0.2, size=50) for _ in range(6)]
    out = {}
    for name, (telemetry, *_rest, slo_mod) in PACKAGES.items():
        reg = telemetry.Registry()
        fam = reg.histogram("mx_req_seconds", "latency",
                            buckets=(0.05, 0.1, 0.25, 0.5, 1.0))
        clock = Clock()
        mon = slo_mod.BurnRateMonitor(windows=(60.0, 600.0),
                                      alert_burn_rate=2.0,
                                      eval_interval_s=10.0, registry=reg,
                                      clock=clock)
        mon.add_latency_slo("serve", 0.9, 0.25, "mx_req_seconds",
                            registry=reg)
        evals = []
        for batch in samples:
            for v in batch:
                fam.observe(float(v))
            clock.t += 30.0
            evals.append(mon.evaluate())
        out[name] = (evals, reg.render_prometheus())
    assert out["port"] == out["jax"]
    assert any(b > 0 for e in out["port"][0] for b in e["serve"].values())


def _spans():
    """Nested complete events on two threads, with thread names."""
    ev = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
           "args": {"name": "main"}},
          {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
           "args": {"name": "writer"}}]
    rng = np.random.RandomState(9)
    t = 0.0
    for step in range(5):
        dur = 1000.0 + float(rng.randint(0, 500))
        ev.append({"ph": "X", "name": "train_step::step", "pid": 1,
                   "tid": 1, "ts": t, "dur": dur})
        ev.append({"ph": "X", "name": "train_step::dispatch", "pid": 1,
                   "tid": 1, "ts": t + 10.0, "dur": dur * 0.6})
        ev.append({"ph": "X", "name": "cached_op::execute", "pid": 1,
                   "tid": 1, "ts": t + 20.0, "dur": dur * 0.3})
        ev.append({"ph": "X", "name": "checkpoint::write", "pid": 1,
                   "tid": 2, "ts": t + 5.0, "dur": 300.0})
        t += dur + 50.0
    return {"traceEvents": ev}


def test_collapsed_stacks_are_the_jax_packages():
    got = flame.collapsed(_spans())
    assert got == jflame.collapsed(_spans())
    assert "main;train_step::step;train_step::dispatch;" \
        "cached_op::execute" in got
    a, b = _spans(), _spans()
    for e in b["traceEvents"]:
        if e.get("name") == "cached_op::execute":
            e["dur"] *= 2
    assert flame.render_diff(flame.collapsed(a), flame.collapsed(b)) == \
        jflame.render_diff(jflame.collapsed(a), jflame.collapsed(b))


@pytest.mark.parametrize("series", ["steady_then_slow", "regime_change"])
def test_step_monitor_anomalies_are_the_jax_packages(series):
    rng = np.random.RandomState(3)
    if series == "steady_then_slow":
        times = list(0.1 + rng.rand(30) * 0.01)
        times[12] = times[25] = 0.9
    else:
        times = list(0.1 + rng.rand(15) * 0.01) + \
            list(0.5 + rng.rand(15) * 0.01)
    out = {}
    for name, (_, _, _, _, health_mod, _, _) in PACKAGES.items():
        mon = health_mod.StepMonitor(slow_factor=3.0, warmup_steps=5,
                                     clock=Clock())
        flagged = [mon.observe_step(t, step=i) for i, t in enumerate(times)]
        snap = mon.snapshot()
        out[name] = (flagged, snap["anomalies"], snap["steps"],
                     round(snap["ewma_ms"], 9))
    assert out["port"] == out["jax"]


def _goodput_run(telemetry, good_mod, tmp):
    tmp.mkdir()
    clock = Clock(50.0)
    reg = telemetry.Registry()
    ledger = good_mod.GoodputLedger(directory=str(tmp), rank=0,
                                    interval_s=0.0, closure_pct=2.0,
                                    registry=reg, clock=clock)
    timeline = [("step", 1, 0.8), ("book", "checkpoint", 0.3),
                ("step", 2, 0.75), ("book", "input_stall", 0.2),
                ("step", 3, 0.9), ("book", "h2d", 0.05),
                ("step", 4, 0.7)]
    snaps = []
    for kind, a, b in timeline:
        clock.t += 1.25
        if kind == "step":
            ledger.observe_step(a, b)
        else:
            ledger.book(a, b)
        ledger.tick()
        snap = ledger.snapshot()
        snap.pop("updated_unix")
        snaps.append(snap)
    ledger.close()
    # A restart: the next incarnation resumes from step 2's checkpoint.
    clock.t += 5.0
    again = good_mod.GoodputLedger(directory=str(tmp), rank=0,
                                   interval_s=0.0, registry=reg,
                                   clock=clock)
    again.resume_from(2)
    for step in (3, 4, 5):
        clock.t += 1.0
        again.observe_step(step, 0.8)
    snap = again.snapshot()
    snap.pop("updated_unix")
    snaps.append(snap)
    return snaps, good_mod.fleet_snapshot(reg)


def test_goodput_snapshots_are_the_jax_packages(tmp_path):
    port = _goodput_run(tel, good, tmp_path / "port")
    jax_ = _goodput_run(jtel, jgood, tmp_path / "jax")
    assert port == jax_
    assert port[0][-1]["restart_replay_steps"] == 2
    assert port[0][-1]["categories"]["restart_replay"] > 0
