"""The port's ``mx.profiler`` against the JAX package's.

The same ``nd`` program runs in both packages while each profiler runs:
the per-op dispatch tables (``dumps(format="json")``) list the same op
names with the same call counts. The port's device trace is a
torch.profiler session: ``set_state('run')`` ... ``dump()`` writes one
chrome-trace JSON where ``set_config(filename=)`` says (a CPU trace on
the host), ``dump(finished=False)`` keeps profiling, and
``pause``/``resume`` stop and restart the dispatch table.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _stopped():
    yield
    for m in (mx, jmx):
        m.profiler.set_state("stop")
        m.profiler.dumps(reset=True)


def _program(m, ctx=None):
    rng = np.random.RandomState(0)
    kw = {} if ctx is None else {"ctx": ctx}
    a = m.nd.array(rng.rand(8, 16).astype(np.float32), **kw)
    w = m.nd.array(rng.rand(4, 16).astype(np.float32), **kw)
    h = m.nd.FullyConnected(a, w, num_hidden=4, no_bias=True)
    h = m.nd.relu(h)
    s = m.nd.softmax(h, axis=-1)
    t = m.nd.sum(s * 2.0, axis=1)
    u = m.nd.dot(a, a.T)
    return (t.asnumpy(), u.asnumpy())


def _table(m, tmp, ctx=None):
    m.profiler.set_config(filename=str(tmp / "trace.json"))
    m.profiler.dumps(reset=True)
    m.profiler.set_state("run")
    out = _program(m, ctx)
    m.profiler.set_state("stop")
    table = json.loads(m.profiler.dumps(format="json", reset=True))["ops"]
    return out, {name: row["calls"] for name, row in table.items()}


def test_op_table_lists_the_jax_packages_ops_and_counts(tmp_path):
    (jd, jax_ops) = _table(jmx, tmp_path / "jax")
    (pd, port_ops) = _table(mx, tmp_path / "port", ctx=mx.cpu())
    np.testing.assert_allclose(pd[0], jd[0], rtol=1e-5)
    np.testing.assert_allclose(pd[1], jd[1], rtol=1e-5)
    assert port_ops == jax_ops
    assert port_ops["FullyConnected"] == 1 and len(port_ops) >= 5


def test_nothing_is_recorded_when_stopped_or_paused(tmp_path):
    mx.profiler.set_config(filename=str(tmp_path / "p"))
    _program(mx, mx.cpu())
    assert json.loads(mx.profiler.dumps(format="json"))["ops"] == {}
    mx.profiler.set_state("run")
    mx.profiler.pause()
    assert not mx.profiler.is_recording()
    _program(mx, mx.cpu())
    assert json.loads(mx.profiler.dumps(format="json"))["ops"] == {}
    mx.profiler.resume()
    _program(mx, mx.cpu())
    ops = json.loads(mx.profiler.dumps(format="json"))["ops"]
    assert ops["FullyConnected"]["calls"] == 1
    assert "FullyConnected" in mx.profiler.dumps()
    assert "FullyConnected" in mx.profiler.dumps(format="top")


def test_dump_writes_one_chrome_trace_where_filename_says(tmp_path):
    mx.profiler.set_config(filename=str(tmp_path / "prof"))
    mx.profiler.set_state("run")
    _program(mx, mx.cpu())
    mid = mx.profiler.dump(finished=False)          # keeps profiling
    assert mid == str(tmp_path / "prof.json")
    assert mx.profiler.is_recording()
    _program(mx, mx.cpu())
    path = mx.profiler.dump()
    assert path == mid and not mx.profiler.is_recording()
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    # CPU operator events of the program (aten ops under the port's).
    assert any(n and n.startswith("aten::") for n in names), sorted(
        n for n in names if n)[:20]
    assert json.loads(mx.profiler.dumps(format="json"))["trace_file"] == \
        path
    # After stop, dump writes the stopped session again.
    assert mx.profiler.dump() == path


def test_bad_state_and_format_raise():
    with pytest.raises(ValueError):
        mx.profiler.set_state("go")
    with pytest.raises(ValueError):
        mx.profiler.dumps(format="xml")
    with pytest.raises(RuntimeError, match="set_kvstore_handle"):
        mx.profiler.set_state("run", profile_process="server")


def test_libinfo_keeps_the_jax_packages_keys():
    got, want = mx.libinfo.features(), jmx.libinfo.features()
    assert sorted(got) == sorted(want)
    assert got["TPU"] is False and got["XLA"] is False
    assert got["CUDA"] == (torch.version.cuda is not None)
    assert got["OPENCV"] == want["OPENCV"]
    assert all(p.endswith(".so") for p in mx.libinfo.find_lib_path())
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("role", ["server", "scheduler", "worker"])
def test_a_server_process_traces_the_cpu_only(role, monkeypatch):
    from torch.profiler import ProfilerActivity

    monkeypatch.setenv("DMLC_ROLE", role)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    want = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if role == "worker" else [])
    assert mx.profiler._activities() == want


def test_a_session_opens_its_window_after_the_primer(tmp_path, monkeypatch):
    # CUDA activity on, the primer, then the window: the first kernel
    # records torch.profiler drops after it enables CUDA activity are the
    # primer's. On the host, with CUDA never initialised, the primer
    # launches nothing.
    prof_mod = mx.profiler
    calls = []
    real_prime = prof_mod._prime
    monkeypatch.setattr(prof_mod, "_prime", lambda acts: (
        calls.append("prime"), real_prime(acts)))
    session = prof_mod.open_session()
    assert session is not None
    for name in ("prepare_trace", "start_trace"):
        real = getattr(session.prof, name)
        monkeypatch.setattr(session.prof, name, lambda real=real, name=name: (
            calls.append(name), real()))
    with session:
        _program(mx, mx.cpu())
    assert calls == ["prepare_trace", "prime", "start_trace"]
    path = prof_mod.export_trace(session, str(tmp_path / "t.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert not torch.cuda.is_initialized()


def test_the_primer_grows_with_the_process_age(monkeypatch):
    prof_mod = mx.profiler
    now = prof_mod.time.monotonic()
    monkeypatch.setattr(prof_mod, "_T_IMPORT", now)
    assert prof_mod._primer_launches() == prof_mod._PRIMER_FLOOR
    monkeypatch.setattr(prof_mod, "_T_IMPORT", now - 3600.0)
    assert prof_mod._primer_launches() >= prof_mod._PRIMER_FLOOR + int(
        prof_mod._PRIMER_PER_SECOND * 3600.0)


def test_profile_trace_loss_finds_the_launches_without_kernel_records():
    from mxnet_tpu_torch import profile_trace_loss as ptl

    def ev(cat, name, corr, ts):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    events = [ev("cuda_runtime", "cudaLaunchKernel", c, 10 * c)
              for c in range(1, 7)]
    events += [ev("cuda_driver", "cuLaunchKernel", 7, 70),
               ev("cuda_runtime", "cudaDeviceSynchronize", 8, 80)]
    events += [ev("kernel", "k%d" % c, c, 10 * c + 5) for c in (3, 4, 5, 7)]
    assert ptl._lost(events) == (7, 3, 0, 5)
    assert ptl._lost(events[:0]) == (0, 0, None, None)
    if not torch.cuda.is_available():
        assert ptl.main(["--session", "torch"]) == 2


def test_a_session_beside_a_training_thread_starts_and_stops_while_it_parks(
        monkeypatch):
    # A health plane's /debug/xprof starts and stops its session on its
    # own thread while another trains: each transition runs while the
    # training thread waits at its step boundary.
    import threading
    import time

    prof_mod = mx.profiler
    state = {"in_step": False, "steps": 0}
    done = threading.Event()

    def train():
        while not done.is_set():
            prof_mod.step_boundary()
            state["in_step"] = True
            time.sleep(0.005)           # the step's launches
            state["in_step"] = False
            state["steps"] += 1

    worker = threading.Thread(target=train, daemon=True)
    worker.start()
    try:
        while state["steps"] < 3:
            time.sleep(0.001)
        seen = {}
        session = prof_mod.open_session()
        assert session is not None
        for name in ("prepare_trace", "start_trace", "stop"):
            real = getattr(session.prof, name)

            def wrapped(real=real, name=name):
                samples = []
                for _ in range(5):
                    samples.append(state["in_step"])
                    time.sleep(0.004)
                seen[name] = samples
                return real()
            monkeypatch.setattr(session.prof, name, wrapped)
        with session:
            steps = state["steps"]
            time.sleep(0.05)
            assert state["steps"] > steps       # it trains in the window
    finally:
        done.set()
        worker.join(timeout=10)
    assert seen == {name: [False] * 5
                    for name in ("prepare_trace", "start_trace", "stop")}
    assert prof_mod._park_request is None


def test_a_session_on_the_training_thread_itself_does_not_wait():
    # The step boundaries of TrainStep and gluon.Trainer are the calling
    # thread's own: a session it opens after a step starts at once.
    import threading
    import time

    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    with mx.autograd.record():
        loss = net(mx.nd.ones((2, 3), ctx=mx.cpu())).sum()
    loss.backward()
    trainer.step(2)
    assert threading.get_ident() in mx.profiler._boundaries
    t0 = time.monotonic()
    session = mx.profiler.open_session()
    with session:
        _program(mx, mx.cpu())
    assert time.monotonic() - t0 < mx.profiler._PARK_S / 2


class _SlowModel:
    """A served model whose batch takes `seconds` on the worker thread,
    flagging while it runs."""

    compile_count = 0

    def __init__(self, seconds):
        self.seconds = seconds
        self.in_batch = False
        self.batches = 0

    def __call__(self, batch):
        import time

        self.in_batch = True
        time.sleep(self.seconds)
        self.in_batch = False
        self.batches += 1
        return batch


def test_an_idle_serving_loop_does_not_delay_a_session():
    # The server's worker marks itself idle after each batch: a session
    # opened while it waits on its queue starts and stops at once, where
    # its last batch (1 s) would otherwise hold the start up to 2.1 s.
    import time

    model = _SlowModel(1.0)
    server = mx.serving.InferenceServer(
        model=model, item_shape=(2,), max_batch=1, ctx=mx.cpu(),
        warmup=False)
    try:
        for _ in range(2):
            server.predict(np.ones((1, 2), np.float32))
        t0 = time.monotonic()
        with mx.profiler.open_session():
            pass
        assert time.monotonic() - t0 < 0.5
    finally:
        server.shutdown()
    assert model.batches == 2


def test_a_busy_serving_loop_parks_while_a_session_starts_and_stops(
        monkeypatch):
    # Under load the server's worker parks before its next batch while
    # another thread starts or stops a session: no batch runs inside a
    # transition, and batches run inside the window.
    import threading
    import time

    model = _SlowModel(0.005)
    server = mx.serving.InferenceServer(
        model=model, item_shape=(2,), max_batch=1, max_delay_ms=0.0,
        ctx=mx.cpu(), warmup=False)
    done = threading.Event()

    def load():
        while not done.is_set():
            server.predict(np.ones((1, 2), np.float32))

    clients = [threading.Thread(target=load, daemon=True) for _ in range(2)]
    for c in clients:
        c.start()
    try:
        while model.batches < 5:
            time.sleep(0.001)
        seen = {}
        session = mx.profiler.open_session()
        for name in ("prepare_trace", "start_trace", "stop"):
            real = getattr(session.prof, name)

            def wrapped(real=real, name=name):
                samples = []
                for _ in range(5):
                    samples.append(model.in_batch)
                    time.sleep(0.004)
                seen[name] = samples
                return real()
            monkeypatch.setattr(session.prof, name, wrapped)
        with session:
            batches = model.batches
            time.sleep(0.05)
            assert model.batches > batches      # it serves in the window
    finally:
        done.set()
        for c in clients:
            c.join(timeout=10)
        server.shutdown()
    assert seen == {name: [False] * 5
                    for name in ("prepare_trace", "start_trace", "stop")}
    assert mx.profiler._park_request is None


def test_the_gateway_loop_marks_its_batches():
    # The gateway's dispatch loop marks a boundary before each batch and
    # goes idle after it.
    import time

    from mxnet_tpu_torch.serving import gateway

    marks = []
    real_boundary = mx.profiler.step_boundary
    real_idle = mx.profiler.step_idle
    try:
        mx.profiler.step_boundary = lambda: marks.append("b")
        mx.profiler.step_idle = lambda: marks.append("i")
        assert gateway._profiler is mx.profiler
        gw = gateway.ModelGateway(ctx=mx.cpu())
        try:
            gw.register(mx.serving.ModelSpec(
                "m", fn=lambda w, x: x * w,
                params=[mx.nd.ones((2,), ctx=mx.cpu())],
                item_shape=(2,), max_batch=2))
            gw.predict("m", np.ones((1, 2), np.float32))
            time.sleep(0.05)
        finally:
            gw.shutdown()
    finally:
        mx.profiler.step_boundary = real_boundary
        mx.profiler.step_idle = real_idle
    # The warmup runs on the caller's thread; the served batch marks
    # "b" then "i" on the gateway's.
    assert marks[-2:] == ["b", "i"]
