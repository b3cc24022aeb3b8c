"""The port's telemetry hooks on its training paths, against the JAX
package's.

- ``NumericGuard`` installed on each package's ``gluon.Trainer`` fused
  applier, the same weights (crossed as numpy arrays) and batches, one
  NaN gradient at step 2: both record the same (site, step, detail),
  move ``mx_nonfinite_total`` by one and raise ``NonFiniteError`` under
  ``halt``.
- ``CachedOp``: the same input-shape sequence gives the same trace
  count, ``mx_cachedop_compiles_total`` and ``mx_compile_seconds``
  moves, and ``StepMonitor.attach``'s recompile anomalies.
- ``TrainStep``: the same steps move ``mx_train_steps_total`` and
  ``mx_compile_seconds{site="train_step"}`` alike, record the same span
  names (``train_step::device`` with device spans on), flip the same
  readiness slot and leave the ``step`` watchdog lane idle.
- memstats on the host (the live-tensor fallback; CUDA stays
  uninitialised), compile accounting, flight-recorder bundles, and the
  port's ``examples/train_telemetry.py`` at 8 batches.
"""
import json

import numpy as np
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu.telemetry as jtel
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.telemetry import attribution as jattr
from mxnet_tpu.telemetry import healthplane as jhp
from mxnet_tpu.telemetry import memstats as jms
from mxnet_tpu.telemetry import trace as jtrace
from mxnet_tpu.telemetry import watchdog as jwd

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.telemetry as tel
from mxnet_tpu_torch.parallel import TrainStep, make_mesh
from mxnet_tpu_torch.telemetry import attribution as attr
from mxnet_tpu_torch.telemetry import healthplane as hp
from mxnet_tpu_torch.telemetry import memstats as ms
from mxnet_tpu_torch.telemetry import trace as trace
from mxnet_tpu_torch.telemetry import watchdog as wd

torch.set_num_threads(2)

SHAPES = {"0.weight": (8, 5), "0.bias": (8,), "1.weight": (3, 8),
          "1.bias": (3,)}


def _weights(seed=3):
    rng = np.random.RandomState(seed)
    return {k: (rng.rand(*s).astype(np.float32) - 0.5) for k, s in
            SHAPES.items()}


def _net(pkg, weights, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=5, activation="relu"))
    net.add(pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(**kw)
    params = net.collect_params()
    for i, layer in enumerate(net._children.values()
                              if isinstance(net._children, dict)
                              else net._children):
        layer.weight.set_data(pkg.nd.array(weights["%d.weight" % i], **kw))
        layer.bias.set_data(pkg.nd.array(weights["%d.bias" % i], **kw))
    assert len(params) == 4
    return net


def _batches(n=3, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(6, 5).astype(np.float32),
             rng.randint(0, 3, 6).astype(np.float32)) for _ in range(n)]


def _value(telemetry, name, **labels):
    fam = telemetry.REGISTRY.get(name)
    if fam is None:
        return 0.0
    child = fam.labels(**labels) if labels else fam
    snap = getattr(child, "snapshot", None)
    return snap()["count"] if snap else child.value


def _guarded_run(pkg, telemetry, ctx=None, nan_at=2):
    kw = {} if ctx is None else {"ctx": ctx}
    net = _net(pkg, _weights(), ctx)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    guard = telemetry.NumericGuard(halt=True)
    guard.install(trainer._applier)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    before = _value(telemetry, "mx_nonfinite_total", site="grad")
    raised = None
    for step, (x, y) in enumerate(_batches(), start=1):
        guard.observe_batch(step=step, batch_ids=[10 * step, 10 * step + 1])
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, **kw)), pkg.nd.array(y, **kw))
        loss.backward()
        if step == nan_at:
            params = net.collect_params()
            w = params[[n for n in sorted(params) if n.endswith("weight")][0]]
            g = np.array(w.grad().asnumpy())
            g[0, 0] = np.nan
            w.grad()[:] = pkg.nd.array(g, **kw)
        try:
            trainer.step(x.shape[0])
        except telemetry.NonFiniteError as exc:
            raised = (step, str(exc))
            break
    moved = _value(telemetry, "mx_nonfinite_total", site="grad") - before
    return ([(site, step, ids, detail)
             for site, step, ids, detail in guard.violations],
            raised, moved, dict(guard._counts))


def test_numeric_guard_through_the_trainer_is_the_jax_packages():
    port = _guarded_run(mx, tel, ctx=mx.cpu())
    jax_ = _guarded_run(jmx, jtel)
    assert port[0] == jax_[0]
    assert port[0][0][:3] == ("grad", 2, [20, 21])
    assert port[1][0] == jax_[1][0] == 2
    assert "step 2" in port[1][1] and "in-flight batch ids: [20, 21]" \
        in port[1][1]
    assert port[2] == jax_[2] == 1
    assert port[3] == jax_[3] == {"grad": 2}


def test_numeric_guard_checks_the_loss_and_its_cadence():
    guard = tel.NumericGuard(every=2)
    assert guard.check_loss(torch.tensor(float("nan")), step=1)   # skipped
    assert not guard.check_loss(torch.tensor(float("nan")), step=2)
    assert guard.check_loss(mx.nd.array(np.ones(3), ctx=mx.cpu()), step=4)
    assert [v[:2] for v in guard.violations] == [("loss", 2)]
    off = tel.NumericGuard(every=0)
    net = _net(mx, _weights(), mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd")
    off.install(trainer._applier)
    x, y = _batches(1)[0]
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x, ctx=mx.cpu())), mx.nd.array(y, ctx=mx.cpu()))
    loss.backward()
    trainer.step(6)
    assert off._counts == {} and off._pending == []


def _cached_run(pkg, telemetry, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    op = pkg.cached_op.CachedOp(lambda x: x * 2 + 1)
    mon = telemetry.StepMonitor(expected_traces=1)
    mon.attach(op)
    name = op.name if hasattr(op, "name") else op._op.name
    c0 = _value(telemetry, "mx_cachedop_compiles_total", op=name)
    s0 = _value(telemetry, "mx_compile_seconds", site="cached_op")
    outs = []
    for rows in (2, 2, 4, 5, 4, 2):
        outs.append(op(pkg.nd.array(np.arange(rows * 3, dtype=np.float32)
                                    .reshape(rows, 3), **kw)).asnumpy())
    return (op.num_traces,
            _value(telemetry, "mx_cachedop_compiles_total", op=name) - c0,
            _value(telemetry, "mx_compile_seconds", site="cached_op") - s0,
            mon.snapshot()["anomalies"], [o.tolist() for o in outs])


def test_cached_op_hooks_are_the_jax_packages():
    port = _cached_run(mx, tel, mx.cpu())
    assert port == _cached_run(jmx, jtel)
    assert port[:4] == (3, 3, 3, {"recompile": 2})


def _span_names(trace_mod):
    return sorted({e["name"] for e in trace_mod.chrome_trace()["traceEvents"]
                   if e.get("ph") == "X"
                   and e["name"].startswith("train_step::")})


def _step_run(pkg, telemetry, trace_mod, hp_mod, wd_mod, attr_mod, mesh,
              ctx=None):
    step = (TrainStep if pkg is mx else JTrainStep)(
        _net(pkg, _weights(), ctx), pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
        "sgd", {"learning_rate": 0.1}, mesh=mesh)
    trace_mod.clear()
    n0 = _value(telemetry, "mx_train_steps_total")
    c0 = _value(telemetry, "mx_compile_seconds", site="train_step")
    losses = []
    for i, (x, y) in enumerate(_batches(3)):
        if i == 2:
            attr_mod.set_device_spans(True)
        try:
            losses.append(float(np.asarray(
                step(x, y) if pkg is jmx else step(x, y).item())))
        finally:
            attr_mod.set_device_spans(False)
    lanes = wd_mod.lane_snapshot()
    return (_value(telemetry, "mx_train_steps_total") - n0,
            _value(telemetry, "mx_compile_seconds", site="train_step") - c0,
            hp_mod.readiness().get(step._hp_component),
            lanes["step"]["busy_s"] is None,
            np.array(losses))


def test_train_step_hooks_are_the_jax_packages():
    trace.set_enabled(True)
    port = _step_run(mx, tel, trace, hp, wd, attr,
                     make_mesh({"dp": 1}, devices=[mx.cpu()]), mx.cpu())
    names = _span_names(trace)
    jport = _step_run(jmx, jtel, jtrace, jhp, jwd, jattr,
                      jmake_mesh({"dp": 1}, devices=[jax.devices()[0]]))
    assert port[:4] == jport[:4] == (3, 1, True, True)
    np.testing.assert_allclose(port[4], jport[4], rtol=1e-5)
    assert names == _span_names(jtrace)
    assert "train_step::device" in names and "train_step::dispatch" in names


def test_step_attribution_reads_the_port_spans():
    with tel.StepAttribution(interval_s=0.0) as attribution:
        step = TrainStep(_net(mx, _weights(), mx.cpu()),
                         mx.gluon.loss.L2Loss(), "sgd",
                         mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
        attribution.update()            # consume the spans so far
        for x, y in _batches(2):
            step(x, np.zeros((6, 3), np.float32))
        window = attribution.update()
    assert not attr.device_spans_enabled()
    assert window["dispatch"] > 0.0 and window["h2d"] >= 0.0
    snap = attribution.snapshot()
    assert snap["bound_cause"] in attr.BOUND_CAUSES
    assert snap["executables"] == {}


def test_memstats_on_the_host_and_compile_accounting():
    keep = torch.ones(1 << 16)            # 256 KiB live on the host
    sample = ms.sample_device_memory()
    assert list(sample) == ["cpu"]
    assert sample["cpu"]["bytes"] >= keep.numel() * 4
    assert sample["cpu"]["peak_bytes"] >= sample["cpu"]["bytes"]
    assert sample["cpu"]["limit_bytes"] is None
    ms.reset_peak()
    assert not torch.cuda.is_initialized()
    mon = tel.DeviceMemoryMonitor(interval_s=0.0)
    assert mon.tick()["cpu"]["bytes"] > 0
    rng = np.random.RandomState(1)
    values = list(rng.exponential(0.5, size=17))
    for v in values:
        ms.observe_compile("parity_site", v)
        jms.observe_compile("parity_site", v)
    assert ms.compile_stats()["parity_site"] == \
        jms.compile_stats()["parity_site"]


def test_flight_recorder_bundles_have_the_jax_packages_sections(tmp_path):
    out = {}
    for name, telemetry in (("port", tel), ("jax", jtel)):
        mon = telemetry.StepMonitor()
        rec = telemetry.FlightRecorder(str(tmp_path / name), rank=0,
                                       rate_limit_s=0.0)
        rec.attach(mon)
        mon.record_anomaly("nonfinite", "probe")
        with open(rec.bundles[-1]) as f:
            bundle = json.load(f)
        out[name] = (sorted(bundle), sorted(bundle["meta"]),
                     bundle["meta"]["kind"], bundle["env"])
    assert out["port"][:3] == out["jax"][:3]
    env = out["port"][3]
    assert env["torch"] == torch.__version__ and "jax" not in env


def test_the_telemetry_example_runs_to_its_end(tmp_path):
    from mxnet_tpu_torch.examples import train_telemetry

    assert train_telemetry.main(["--num-batches", "8", "--cpu",
                                 "--out-dir", str(tmp_path)]) == 0
    assert (tmp_path / "chrome_trace.json").stat().st_size > 0
