"""The port's health plane against the JAX package's.

Both packages' ``HealthPlane`` handlers get the same state (the same
watchdog lanes, readiness components, recorder and pipeline) and must
answer each route with the same status and the same body keys. The
port's ``POST /debug/xprof`` captures over torch.profiler: on the host a
CPU trace, one chrome-trace file in the capture directory. The
endpoints are also driven over real HTTP on the port's ``/metrics``
server, with a TrainStep's readiness slot answering 503 during its first
step and 200 after it, and ``DiagCollector`` collects one bundle per rank
over a ``LocalBus`` as the JAX package's does.
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu.telemetry as jtel
from mxnet_tpu.telemetry import aggregate as jagg
from mxnet_tpu.telemetry import healthplane as jhp
from mxnet_tpu.telemetry import watchdog as jwd

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.telemetry as tel
from mxnet_tpu_torch.telemetry import aggregate as agg
from mxnet_tpu_torch.telemetry import healthplane as hp
from mxnet_tpu_torch.telemetry import watchdog as wd

torch.set_num_threads(2)

PACKAGES = {"jax": (jtel, jhp, jwd, jagg), "port": (tel, hp, wd, agg)}


@pytest.fixture(autouse=True)
def _clean_plane():
    for _, plane_mod, wd_mod, _ in PACKAGES.values():
        wd_mod.reset()
        plane_mod.reset()
    yield
    for _, plane_mod, wd_mod, _ in PACKAGES.values():
        wd_mod.reset()
        plane_mod.reset()


class _Pipe:
    def debug_state(self):
        return {"watermark": {"epoch": 1}, "last_batch": {"ids": [3]}}


def _plane(pkg, tmp, xprof=True):
    telemetry, plane_mod, _, _ = PACKAGES[pkg]
    recorder = telemetry.FlightRecorder(str(tmp / pkg / "diag"), rank=0,
                                        rate_limit_s=0.0)
    plane = plane_mod.HealthPlane(
        watchdog=telemetry.HangWatchdog(min_deadline_s=0.05),
        recorder=recorder,
        xprof_dir=str(tmp / pkg / "xprof") if xprof else None)
    plane.watch_pipeline(_Pipe())
    return plane


def _keys(routed):
    status, body = routed[0], routed[1]
    return status, sorted(body) if isinstance(body, dict) else type(body)


ROUTES = [("GET", "/healthz"), ("GET", "/readyz"),
          ("GET", "/debug/stacks"), ("GET", "/debug/watchdog"),
          ("GET", "/debug/pipeline"), ("GET", "/debug/memory"),
          ("GET", "/debug/pprof"), ("GET", "/debug/pprof?seconds=x"),
          ("GET", "/debug/pprof?format=svg"),
          ("GET", "/debug/attribution"), ("GET", "/debug/goodput"),
          ("POST", "/debug/bundle"), ("POST", "/debug/xprof?seconds=x"),
          ("GET", "/nonsense"), ("POST", "/nonsense")]


@pytest.mark.parametrize("state", ["idle", "hung", "warming"])
def test_handlers_answer_as_the_jax_package(state, tmp_path):
    out = {}
    for pkg in PACKAGES:
        _, plane_mod, wd_mod, _ = PACKAGES[pkg]
        plane = _plane(pkg, tmp_path)
        if state == "hung":
            wd_mod.begin("step")
            time.sleep(0.06)
        if state == "warming":
            plane_mod.unique_component("train_step")
            plane_mod.set_ready(plane_mod.unique_component("serving"))
        got = {}
        for method, path in ROUTES:
            routed = plane.handle(method, path)
            got[(method, path)] = None if routed is None else _keys(routed)
        got["readyz"] = plane.handle("GET", "/readyz")[1]
        got["lanes"] = sorted(
            (k, v["overdue"]) for k, v in
            plane.handle("GET", "/healthz")[1]["lanes"].items())
        got["pipeline"] = plane.handle("GET", "/debug/pipeline")[1]
        if state == "hung":
            wd_mod.end("step")
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert out["port"][("GET", "/healthz")][0] == \
        (503 if state == "hung" else 200)
    assert out["port"][("GET", "/readyz")][0] == \
        (503 if state == "warming" else 200)


def test_xprof_on_the_host_writes_one_cpu_trace(tmp_path):
    plane = _plane("port", tmp_path)
    status, body = plane.handle("POST", "/debug/xprof?seconds=0.1")
    assert status == 200 and sorted(body) == ["dir", "seconds"]
    assert os.listdir(body["dir"]) == [hp.XPROF_TRACE]
    with open(os.path.join(body["dir"], hp.XPROF_TRACE)) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    # The JAX package's capture answers the same status and keys.
    jstatus, jbody = _plane("jax", tmp_path).handle(
        "POST", "/debug/xprof?seconds=0.1")
    assert (jstatus, sorted(jbody)) == (status, sorted(body))
    # Without a capture root: 404, as there.
    no_root = _plane("port", tmp_path / "b", xprof=False)
    no_root._recorder = None
    assert no_root.handle("POST", "/debug/xprof")[0] == 404


def test_xprof_answers_409_while_the_profiler_runs(tmp_path):
    plane = _plane("port", tmp_path)
    mx.profiler.set_config(filename=str(tmp_path / "prof.json"))
    mx.profiler.set_state("run")
    try:
        status, body = plane.handle("POST", "/debug/xprof?seconds=0.05")
        assert status == 409, body
    finally:
        mx.profiler.set_state("stop")
    assert plane.handle("POST", "/debug/xprof?seconds=0.05")[0] == 200
    # And the other way round: a capture holds the session slot.
    held = mx.profiler.open_session()
    try:
        with pytest.raises(RuntimeError, match="another torch.profiler"):
            mx.profiler.set_state("run")
        assert plane.handle("POST", "/debug/xprof?seconds=0.05")[0] == 409
    finally:
        held.start()
        held.stop()


def _http(url, method="GET"):
    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_endpoints_over_http_and_train_step_readiness(tmp_path):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    plane = _plane("port", tmp_path)
    server = tel.start_http_server(0, health=plane)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        with mx.cpu():
            net = gluon.nn.Dense(4, in_units=4)
        net.initialize(ctx=mx.cpu())
        seen = []

        def loss(pred, label):
            # Runs inside the first step: the slot is claimed, not ready.
            if not seen:
                seen.append(_http(base + "/readyz"))
            return gluon.loss.L2Loss()(pred, label)

        step = TrainStep(net, loss, optimizer="sgd",
                         mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))
        assert _http(base + "/readyz")[0] == 200       # no slot yet
        step(np.ones((2, 4), np.float32), np.zeros((2, 4), np.float32))
        status, body = seen[0]
        assert status == 503
        assert json.loads(body)["components"] == {"train_step": False}
        status, body = _http(base + "/readyz")
        assert status == 200
        assert json.loads(body)["components"] == {"train_step": True}
        assert _http(base + "/healthz")[0] == 200
        status, body = _http(base + "/metrics")
        assert status == 200 and b"mx_train_steps_total" in body
        status, body = _http(base + "/debug/xprof?seconds=0.05", "POST")
        assert status == 200 and "dir" in json.loads(body)
        status, body = _http(base + "/debug/bundle", "POST")
        assert status == 200
        with open(json.loads(body)["bundle"]) as f:
            bundle = json.load(f)
        assert bundle["env"]["torch"] == torch.__version__
        assert "jax" not in bundle["env"]
        assert _http(base + "/nonsense")[0] == 404
    finally:
        server.close()


def _collect(pkg, tmp):
    telemetry, plane_mod, _, aggregate = PACKAGES[pkg]
    bus = aggregate.LocalBus(num_workers=2)
    collectors = []
    for rank in (0, 1):
        rec = telemetry.FlightRecorder(str(tmp / pkg / ("local%d" % rank)),
                                       rank=rank, rate_limit_s=0.0)
        collectors.append(plane_mod.DiagCollector(
            bus.endpoint(rank), rec, interval_s=0.0,
            directory=str(tmp / pkg / "collected") if rank == 0 else None))
    c0, c1 = collectors
    seq = c0.request_pod_bundle("pod_snapshot", "dump the pod")
    c1.step()
    c0.step()
    bundles = []
    for path in sorted(c0.collected):
        with open(path) as f:
            b = json.load(f)
        bundles.append((os.path.relpath(path, str(tmp / pkg)),
                        b["meta"]["kind"], b["meta"]["rank"], sorted(b)))
    return seq, bundles, c0.collect()


def test_diag_collector_collects_as_the_jax_package(tmp_path):
    port = _collect("port", tmp_path)
    assert port == _collect("jax", tmp_path)
    assert [b[2] for b in port[1]] == [0, 1]
