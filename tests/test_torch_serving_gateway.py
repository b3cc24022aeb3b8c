"""The port's multi-model gateway (``serving/{gateway,registry,reload}.py``)
against the JAX package's, on the same numpy weights and schedules.

Every scenario runs once per package and compares what the caller sees:
- ``ModelRegistry.describe()`` gives identical JSON for the same specs,
  and the same specs are refused;
- with the worker paused and a fixed schedule, fair share dispatches in
  the same order; the global pool bound, ``queue_share``, the deadline
  classes, SLO shedding under a fixed clock, per-model readiness and
  unregister with and without drain give the same outcomes and shed
  counts;
- ``QuantizedFnModel``: int8 outputs agree with the JAX package's within
  float32 tolerance (both dequantize the same int8 weights) and bf16
  outputs within bfloat16's rounding; int8 weights are stored int8;
- ``hot_swap`` with ``params=``, ``checkpoint=`` and ``manager=`` bumps
  the generation alike, and a fresh load of the new weights gives the
  post-swap outputs bit for bit (and the JAX package's within float32
  tolerance); under fire it drops nothing;
- ``CachedOp.pad_to_buckets`` pads 5 rows onto the 8-row signature;
- the mesh-sharded model over two gloo ranks (tests/torch_gateway_mesh_prog.py)
  is the unsharded port model bit for bit and the JAX package's within
  float32 tolerance; without a group of the mesh's size it raises;
- the engine's readiness gate and watchdog lane; the port's
  ``examples/serve_mnist.py`` runs to its end.
The card tests are in tests/test_torch_serving_card.py.
"""
import gc
import json
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.serving as jserving
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving

from torch_dist_prog import launch
from torch_gateway_mesh_prog import MESH_PARAMS, PROG, mlp, mlp_params

torch.set_num_threads(2)

C = mx.cpu()
PKGS = {"jax": (jmx, jserving, {}), "port": (mx, serving, {"ctx": C})}
W = np.arange(12, dtype=np.float32).reshape(4, 3)


def _dot_for(pkg):
    def dot(w, x):
        return pkg.nd.dot(x, w)
    return dot


def _spec(key, name, w=W, **kw):
    pkg, module, ctx = PKGS[key]
    kw.setdefault("item_shape", (4,))
    kw.setdefault("max_batch", 8)
    return module.ModelSpec(name, fn=_dot_for(pkg),
                            params=[pkg.nd.array(w, **ctx)], **kw)


def _gateway(key, **kw):
    pkg, module, ctx = PKGS[key]
    return module.ModelGateway(**ctx, **kw)


def _both(scenario, *args):
    return scenario("port", *args), scenario("jax", *args)


def _one():
    return np.ones((1, 4), np.float32)


# -- specs and the registry ---------------------------------------------------

BAD_SPECS = {
    "no_source": dict(item_shape=(4,)),
    "fn_and_checkpoint": dict(fn=True, checkpoint="p", item_shape=(4,)),
    "unknown_quantize": dict(fn=True, item_shape=(4,), quantize="fp8"),
    "quantized_checkpoint": dict(checkpoint="p", item_shape=(4,),
                                 quantize="int8"),
    "mesh_checkpoint": dict(checkpoint="p", item_shape=(4,),
                            mesh_axes={"tp": 2}),
    "zero_weight": dict(fn=True, item_shape=(4,), weight=0),
    "no_classes": dict(fn=True, item_shape=(4,), deadline_classes=()),
    "duplicate_classes": dict(fn=True, item_shape=(4,),
                              deadline_classes=(("a", 1), ("a", 2))),
    "queue_share": dict(fn=True, item_shape=(4,), queue_share=1.5),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_the_same_specs_are_refused(case):
    for key in PKGS:
        pkg, module, _ = PKGS[key]
        kw = dict(BAD_SPECS[case])
        if kw.get("fn") is True:
            kw["fn"] = _dot_for(pkg)
        with pytest.raises(ValueError):
            module.ModelSpec("x", **kw)


def _describe(key):
    pkg, module, _ = PKGS[key]
    reg = module.ModelRegistry()
    reg.register(_spec(key, "mnist", weight=2.0, slo=(0.99, 0.25),
                       quantize="int8",
                       deadline_classes=(("interactive", 50.0),
                                         ("batch", None))))
    reg.register(_spec(key, "mesh", mesh_axes={"tp": 2}, max_batch=4))
    reg.register(_spec(key, "b16", quantize="bf16", buckets=(2, 6),
                       max_delay_ms=2.0, queue_share=0.5))
    reg.register(module.ModelSpec("ckpt", checkpoint="prefix", epoch=3,
                                  item_shape=(3, 8, 8), dtype="float16"))
    reg.register(module.ModelSpec(
        "lm", params=[], max_batch=16,
        decode=module.DecodeConfig(lambda *a: a, state_shape=[(2, 4), (3,)],
                                   init=lambda *a: a, page_slots=4,
                                   max_tokens=9, stop_token=0,
                                   max_prompt_len=32)))
    reg.bump("mnist")
    with pytest.raises(ValueError):
        reg.register(_spec(key, "mnist"))
    with pytest.raises(KeyError):
        reg.spec("ghost")
    return json.dumps(reg.describe(), sort_keys=True)


def test_registry_describe_is_identical_json():
    got, want = _both(_describe)
    assert got == want
    assert json.loads(got)["mnist"]["generation"] == 2


# -- one pool, fair share ------------------------------------------------------

class _Recorder:
    """Wraps a backend to record dispatch order (the worker snapshots the
    backend per batch, so wrapping between pause and resume is safe)."""

    def __init__(self, inner, name, log):
        self._inner, self._name, self._log = inner, name, log

    def __call__(self, batch):
        self._log.append(self._name)
        return self._inner(batch)

    @property
    def compile_count(self):
        return self._inner.compile_count


def _fair_share(key):
    gw = _gateway(key, max_queue=64)
    try:
        gw.register(_spec(key, "fa", weight=3.0))
        gw.register(_spec(key, "fb", weight=1.0))
        gw.register(_spec(key, "fc", weight=2.0))
        log = []
        for m in "abc":
            gw._state("f" + m).backend = _Recorder(
                gw._state("f" + m).backend, m, log)
        gw.pause()
        x = np.ones((8, 4), np.float32)   # a full bucket: one dispatch each
        futs = [gw.submit("f" + m, x)
                for m, n in (("a", 12), ("b", 4), ("c", 6))
                for _ in range(n)]
        gw.resume()
        outs = [f.result(timeout=30) for f in futs]
        return "".join(log), [o.model for o in outs]
    finally:
        gw.shutdown()


def test_fair_share_dispatches_in_the_same_order():
    got, want = _both(_fair_share)
    assert got == want
    # b is served at its share from the start, not last.
    assert "b" in got[0][:6] and got[0].count("a") == 12


def _pool_bound(key):
    out = {}
    gw = _gateway(key, max_queue=4)
    try:
        gw.register(_spec(key, "pa"))
        gw.register(_spec(key, "pb", queue_share=0.25))
        gw.pause()
        futs = [gw.submit("pa", _one()) for _ in range(2)]
        futs.append(gw.submit("pb", _one()))
        for m in ("pb", "pa", "pa"):
            try:
                futs.append(gw.submit(m, _one()))
                out.setdefault("admitted", []).append(m)
            except Exception as exc:
                out.setdefault("refused", []).append(
                    (m, type(exc).__name__))
        gw.resume()
        out["shapes"] = [f.result(timeout=30).output.shape for f in futs]
        out["shed"] = {m: gw.stats()[m]["shed"] for m in ("pa", "pb")}
        return out
    finally:
        gw.shutdown()


def test_pool_bound_and_queue_share_refuse_alike():
    got, want = _both(_pool_bound)
    assert got == want
    assert got["refused"] == [("pb", "QueueFullError"),
                              ("pa", "QueueFullError")]


def _deadlines(key):
    gw = _gateway(key)
    try:
        gw.register(_spec(key, "da", deadline_classes=(("interactive", 30),
                                                      ("batch", None))))
        with pytest.raises(ValueError):
            gw.submit("da", _one(), deadline_class="nope")
        gw.pause()
        doomed = gw.submit("da", _one(), deadline_class="interactive")
        survivor = gw.submit("da", _one(), deadline_class="batch")
        time.sleep(0.08)
        gw.resume()
        outcomes = []
        for f in (doomed, survivor):
            try:
                outcomes.append(f.result(timeout=30).output.shape)
            except Exception as exc:
                outcomes.append(type(exc).__name__)
        explicit = gw.predict("da", _one(), deadline_class="interactive",
                              timeout_ms=5000).output.shape
        return outcomes, explicit, gw.stats()["da"]["shed"]
    finally:
        gw.shutdown()


def test_deadline_classes_shed_alike():
    got, want = _both(_deadlines)
    assert got == want
    assert got[0] == ["DeadlineExceededError", (1, 3)]
    assert got[2] == {"deadline:interactive": 1}


def _slo(key):
    pkg, module, _ = PKGS[key]
    gwmod = module.gateway
    clk = {"t": 0.0}
    gw = _gateway(key, burn_windows=(1.0, 5.0), eval_interval_s=0.01,
                  shed_burn_rate=2.0, clock=lambda: clk["t"])
    trail = []
    try:
        gw.register(_spec(key, "hot", slo=(0.9, 0.001),
                          deadline_classes=(("interactive", None),
                                            ("best_effort", None))))
        gw.register(_spec(key, "steady"))
        lat = gwmod._gw_latency.labels(model="hot")
        gw._burn_tick()
        for _ in range(20):
            lat.observe(0.5)
        clk["t"] = 0.5
        gw._burn_tick()
        trail.append(gw.stats()["hot"]["shedding"])
        for m, cls in (("hot", "best_effort"), ("hot", "interactive"),
                       ("steady", None)):
            try:
                gw.predict(m, _one(), deadline_class=cls)
                trail.append("served")
            except Exception as exc:
                trail.append(type(exc).__name__)
        for _ in range(200):
            lat.observe(0.0)
        clk["t"] = 2.5
        gw._burn_tick()
        trail.append(gw.stats()["hot"]["shedding"])
        gw.predict("hot", _one(), deadline_class="best_effort")
        trail.append(gw.stats()["hot"]["shed"])
        gw.unregister("hot")
        fam = pkg.telemetry.metrics.REGISTRY.get("mx_slo_burn_rate")
        trail.append([v for v, _ in fam.collect() if v[0] == "gateway_hot"])
        return trail
    finally:
        gw.shutdown()


def test_slo_burn_sheds_the_lowest_class_under_a_fixed_clock():
    got, want = _both(_slo)
    assert got == want
    assert got[:5] == [True, "ServiceUnavailableError", "served", "served",
                       False]
    assert got[5] == {"slo_burn:best_effort": 1}


def _readiness(key):
    pkg, module, _ = PKGS[key]
    hp = pkg.telemetry.healthplane
    hp.reset()
    trail = []
    try:
        gw = _gateway(key)
        try:
            gw.register(_spec(key, "ra"))
            gw.register(_spec(key, "cold"), warmup=False)
            comp = "gateway/cold"
            trail.append(hp.readiness()[comp])
            try:
                gw.submit("cold", _one())
            except Exception as exc:
                trail.append(type(exc).__name__)
            trail.append(hp.is_ready())
            trail.append(gw.predict("ra", _one()).output.shape)
            trail.append(gw.stats()["cold"]["shed"])
            gw.warmup("cold")
            trail.append(hp.readiness()[comp])
            trail.append(gw.predict("cold", _one()).output.shape)
            gw.unregister("cold")
            trail.append(comp in hp.readiness())
            trail.append(hp.is_ready())
        finally:
            gw.shutdown()
        trail.append([c for c in hp.readiness() if c.startswith("gateway/")])
        return trail
    finally:
        hp.reset()


def test_readiness_is_per_model():
    got, want = _both(_readiness)
    assert got == want
    assert got[:3] == [False, "ServiceUnavailableError", False]


def _counter_total(fam):
    return sum(c.value for _, c in fam.collect())


def _unregister(key):
    pkg, module, ctx = PKGS[key]
    gwmod = module.gateway

    def slow_dot(w, x):
        time.sleep(0.05)
        return pkg.nd.dot(x, w)

    class Sleepy:
        # Sleeps on every call (an fn would sleep only where the JAX
        # package traces), holding the worker past the drain deadline.
        compile_count = 0

        def __call__(self, batch):
            time.sleep(1.0)
            return pkg.nd.array(np.ones((batch.shape[0], 3), np.float32),
                                **ctx)

    out = {}
    gw = _gateway(key)
    try:
        # Drained: the accepted requests are served first.
        gw.register(module.ModelSpec("d", fn=slow_dot,
                                     params=[pkg.nd.array(W, **ctx)],
                                     item_shape=(4,), max_batch=1))
        drained0 = _counter_total(gwmod._gw_unreg_drained)
        gw.pause()
        futs = [gw.submit("d", _one()) for _ in range(4)]
        gw.resume()
        gw.unregister("d")
        out["drained"] = [f.result(timeout=10).output.shape for f in futs]
        out["drained_count"] = _counter_total(gwmod._gw_unreg_drained) \
            - drained0 >= 2
        # A drain timeout strands the rest.
        gw.register(_spec(key, "s", max_batch=1))
        gw.swap_backend("s", Sleepy())
        shed0 = _counter_total(gwmod._gw_unreg_shed)
        gw.pause()
        futs = [gw.submit("s", _one()) for _ in range(4)]
        gw.resume()
        gw.unregister("s", drain_timeout=0.3)
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=10)
                outcomes.append("served")
            except Exception as exc:
                outcomes.append(type(exc).__name__)
        out["timeout"] = outcomes
        out["timeout_shed"] = _counter_total(gwmod._gw_unreg_shed) - shed0
        # Without drain, queued requests fail at once.
        gw.register(_spec(key, "n"))
        gw.pause()
        fut = gw.submit("n", _one())
        gw.unregister("n", drain=False)
        gw.resume()
        try:
            fut.result(timeout=5)
        except Exception as exc:
            out["no_drain"] = type(exc).__name__
        out["models"] = gw.models()
        out["series"] = [v for v, _ in gwmod._gw_requests.collect()
                         if v[0] in "dsn"]
        return out
    finally:
        gw.shutdown()


def test_unregister_with_and_without_drain():
    got, want = _both(_unregister)
    assert got == want
    assert got["drained"] == [(1, 3)] * 4 and got["drained_count"]
    assert got["timeout"].count("ServiceUnavailableError") == \
        got["timeout_shed"] >= 1
    assert got["no_drain"] == "ServiceUnavailableError"
    assert got["models"] == [] and got["series"] == []


# -- execution variants --------------------------------------------------------

def _mlp_outputs(key, mode, x):
    pkg, module, ctx = PKGS[key]
    gw = _gateway(key)
    try:
        gw.register(module.ModelSpec(
            "q", fn=mlp(pkg), params=[pkg.nd.array(p, **ctx)
                                      for p in mlp_params()],
            item_shape=(MESH_PARAMS["in"],), max_batch=8, quantize=mode))
        backend = gw._state("q").backend
        out = gw.predict("q", x).output.asnumpy()
        stored = [str(p.dtype) for p in backend._params]
        return out, stored, backend.compile_count
    finally:
        gw.shutdown()


def test_int8_model_agrees_with_the_jax_package():
    x = np.random.default_rng(0).standard_normal(
        (5, MESH_PARAMS["in"]), np.float32)
    got, stored, n = _mlp_outputs("port", "int8", x)
    want, jstored, jn = _mlp_outputs("jax", "int8", x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    # matrices int8 (+ their ranges), vectors float32
    assert stored == jstored == ["int8", "float32", "float32", "float32",
                                 "int8", "float32", "float32", "float32"]
    assert n == jn == 4
    ref = x
    ps = mlp_params()
    ref = np.maximum(ref @ ps[0].T + ps[1], 0) @ ps[2].T + ps[3]
    assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def test_bf16_model_agrees_within_bfloat16_rounding():
    x = np.random.default_rng(1).standard_normal(
        (3, MESH_PARAMS["in"]), np.float32)
    got, stored, n = _mlp_outputs("port", "bf16", x)
    want, jstored, jn = _mlp_outputs("jax", "bf16", x)
    assert got.dtype == np.float32
    assert stored == jstored == ["bfloat16"] * 4
    # A few units of bfloat16's last place (2^-8 relative) of the largest
    # output: both round the same products, in different orders.
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -6 * scale)


def test_held_bytes_of_the_variants():
    ps = mlp_params()
    full = sum(p.nbytes for p in ps)
    fn = serving.registry._FnModel(mlp(mx), [mx.nd.array(p, ctx=C)
                                             for p in ps])
    q8 = serving.QuantizedFnModel(mlp(mx), ps, "int8", ctx=C)
    b16 = serving.QuantizedFnModel(mlp(mx), ps, "bf16", ctx=C)
    assert fn.held_bytes == full
    mats = ps[0].size + ps[2].size
    assert q8.held_bytes == mats + 4 * (ps[1].size + ps[3].size) + 4 * 4
    assert b16.held_bytes == full // 2


# -- hot reload ----------------------------------------------------------------

def _hot_swap(key, tmp_path):
    pkg, module, ctx = PKGS[key]
    x = np.random.default_rng(2).random((2, 4), np.float32)
    out = {}
    gw = _gateway(key)
    mgr = pkg.checkpoint.CheckpointManager(str(tmp_path / key / "mgr"),
                                           keep_last=2)
    try:
        gw.register(_spec(key, "ha"))
        out["r1"] = (gw.predict("ha", x).generation,)
        out["g2"] = module.hot_swap(gw, "ha", params=[pkg.nd.array(W * 5,
                                                                  **ctx)])
        r2 = gw.predict("ha", x)
        fresh = gw.registry.spec("ha").build_backend(
            params=[pkg.nd.array(W * 5, **ctx)])
        want = fresh(pkg.nd.array(np.vstack([x, np.zeros((2, 4),
                                                          np.float32)]),
                                  **ctx)).asnumpy()[:2]
        out["fresh_bit_for_bit"] = bool(np.array_equal(r2.output.asnumpy(),
                                                      want))
        with pytest.raises(ValueError):
            module.hot_swap(gw, "ha", manager=mgr)      # extract= required
        mgr.save(7, {"w": W * 9}, sync=True)
        out["g3"] = module.hot_swap(
            gw, "ha", manager=mgr,
            extract=lambda state: [pkg.nd.array(np.asarray(state["w"]),
                                                **ctx)])
        r3 = gw.predict("ha", x)
        out["r3"] = (r3.generation, r3.output.asnumpy())
        # A checkpoint model, epoch 0 -> 1.
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                     name="gwfc")
        rng = np.random.default_rng(3)
        prefix = str(tmp_path / key / "gwmlp")
        for epoch in (0, 1):
            args = {"gwfc_weight": pkg.nd.array(
                        rng.standard_normal((3, 4), np.float32), **ctx),
                    "gwfc_bias": pkg.nd.array(
                        rng.standard_normal(3, np.float32), **ctx)}
            pkg.model.save_checkpoint(prefix, epoch, net, args, {})
        spec = module.ModelSpec("hc", checkpoint=prefix, epoch=0,
                                item_shape=(4,), max_batch=4, **ctx)
        gw.register(spec)
        c1 = gw.predict("hc", x).output.asnumpy()
        with pytest.raises(ValueError):
            module.hot_swap(gw, "hc", params=[pkg.nd.array(W, **ctx)])
        out["gc"] = module.hot_swap(gw, "hc", checkpoint=True, epoch=1)
        c2 = gw.predict("hc", x)
        fresh = spec.build_backend(checkpoint=prefix, epoch=1)
        out["c_changed"] = not np.array_equal(c1, c2.output.asnumpy())
        out["c_fresh"] = bool(np.array_equal(
            c2.output.asnumpy(),
            fresh(pkg.nd.array(x, **ctx)).asnumpy()))
        out["c2"] = (c2.generation, c2.output.asnumpy())
        out["describe"] = {m: d["generation"]
                           for m, d in gw.registry.describe().items()}
        return out
    finally:
        gw.shutdown()
        mgr.close()


def test_hot_swap_bumps_generations_alike(tmp_path):
    got, want = _hot_swap("port", tmp_path), _hot_swap("jax", tmp_path)
    for k in ("r1", "g2", "g3", "gc", "describe"):
        assert got[k] == want[k], k
    assert got["g2"] == 2 and got["g3"] == 3 and got["gc"] == 2
    assert got["fresh_bit_for_bit"] and want["fresh_bit_for_bit"]
    assert got["c_changed"] and got["c_fresh"] and want["c_fresh"]
    for k in ("r3", "c2"):
        assert got[k][0] == want[k][0]
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=1e-5,
                                   atol=1e-5)


def test_hot_swap_under_fire_drops_nothing():
    gw = serving.ModelGateway(max_queue=10000, max_delay_ms=1.0, ctx=C)
    try:
        gw.register(_spec("port", "fire"))
        old_ref = weakref.ref(gw._state("fire").backend)
        stop = threading.Event()
        results, errors = [], []

        def hammer():
            x = np.random.rand(1, 4).astype(np.float32)
            while not stop.is_set():
                try:
                    results.append((x, gw.predict("fire", x)))
                except Exception as exc:
                    errors.append(exc)

        threads = [threading.Thread(target=hammer) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        gen = serving.hot_swap(gw, "fire", params=[mx.nd.array(W * 7, ctx=C)])
        time.sleep(0.15)
        stop.set()
        for t in threads:
            t.join(30)
        assert not errors, errors[:3]
        assert gen == 2
        assert {r.generation for _, r in results} == {1, 2}
        for x, r in results:
            scale = 7.0 if r.generation == 2 else 1.0
            np.testing.assert_allclose(r.output.asnumpy(), x @ (W * scale),
                                       rtol=1e-5)
        gc.collect()
        assert old_ref() is None, "old backend still referenced"
    finally:
        gw.shutdown()


# -- the CachedOp and the engine ----------------------------------------------

def _padded(key):
    pkg, _, ctx = PKGS[key]
    op = pkg.cached_op.CachedOp(_dot_for(pkg), num_params=1)
    op.pad_to_buckets([1, 2, 4, 8])
    w = pkg.nd.array(W, **ctx)
    x = np.random.default_rng(4).random((5, 4), np.float32)
    y5 = op.inference(w, pkg.nd.array(x, **ctx))
    n5 = op.num_traces
    op.inference(w, pkg.nd.array(np.zeros((8, 4), np.float32), **ctx))
    n8 = op.num_traces
    big = op.inference(w, pkg.nd.array(np.zeros((9, 4), np.float32), **ctx))
    return y5.asnumpy(), n5, n8, op.num_traces, big.shape


def test_pad_to_buckets_runs_the_bucket_signature():
    (y, n5, n8, n9, big), (jy, jn5, jn8, jn9, jbig) = _both(_padded)
    x = np.random.default_rng(4).random((5, 4), np.float32)
    assert y.shape == (5, 3)
    np.testing.assert_allclose(y, x @ W, rtol=1e-6)
    np.testing.assert_allclose(y, jy, rtol=1e-6)
    # 5 rows ran the 8-row signature; 8 rows reuse it; 9 rows (above the
    # ladder) run unpadded on a signature of their own.
    assert (n5, n8, n9, big) == (jn5, jn8, jn9, jbig) == (1, 1, 2, (9, 3))


def test_server_readiness_gate_and_watchdog_lane():
    from mxnet_tpu_torch.telemetry import healthplane as hp
    from mxnet_tpu_torch.telemetry import watchdog as wd

    hp.reset()
    try:
        blocker = hp.unique_component("warming")
        hp.set_ready(blocker, False)
        srv = serving.InferenceServer(_dot_for(mx), [mx.nd.array(W, ctx=C)],
                                      item_shape=(4,), max_batch=4, ctx=C,
                                      shed_unready=True)
        try:
            with pytest.raises(serving.ServiceUnavailableError):
                srv.submit(_one())
            hp.set_ready(blocker)
            assert srv.predict(_one()).shape == (1, 3)
            lane = srv._wd_lane
            assert lane.startswith("serving") and \
                lane in wd.lane_snapshot()
            assert hp.readiness()[srv._hp_component] is True
        finally:
            srv.shutdown()
        assert srv._hp_component not in hp.readiness()
    finally:
        hp.reset()


def test_serve_mnist_example_runs_to_its_end(capsys):
    from mxnet_tpu_torch.examples import serve_mnist

    got = serve_mnist.main(["--cpu", "--train-epochs", "1",
                            "--num-examples", "300", "--requests", "24",
                            "--concurrency", "4"])
    assert got["requests"] == 24
    assert got["compile_count"] == 6
    assert got["shed"] == {"deadline": 1}
    assert got["accuracy"] > 0.5
    assert "serving-throughput" in capsys.readouterr().out


# -- the mesh-sharded model -----------------------------------------------------

def test_mesh_model_needs_a_group_of_its_size():
    with pytest.raises(ValueError, match=r"spans 2 ranks.*has 1"):
        serving.MeshShardedModel(_dot_for(mx), [mx.nd.array(W, ctx=C)],
                                 {"tp": 2}, ctx=C)
    one = serving.MeshShardedModel(_dot_for(mx), [mx.nd.array(W, ctx=C)],
                                   {"tp": 1}, ctx=C)
    x = np.ones((3, 4), np.float32)
    np.testing.assert_array_equal(one(mx.nd.array(x, ctx=C)).asnumpy(),
                                  x @ W)
    assert one.compile_count == 1 and one.held_bytes == W.nbytes


def test_mesh_gateway_over_two_ranks(tmp_path):
    launch(2, 0, "mesh", tmp_path, prog=PROG)
    ranks = [dict(np.load(tmp_path / ("mesh_r%d.npz" % r))) for r in (0, 1)]
    xs = [ranks[0]["x%d" % i] for i in range(int(ranks[0]["n"]))]
    ps = mlp_params()
    want_jax = jserving.engine._FnModel(mlp(jmx),
                                        [jmx.nd.array(p) for p in ps])
    for r, got in enumerate(ranks):
        assert str(got["refused"]).startswith("mesh_axes")
        assert int(got["compile_count"]) == 4
        for i, x in enumerate(xs):
            # The unsharded port model, bit for bit, on every rank.
            np.testing.assert_array_equal(got["y%d" % i], got["u%d" % i])
            bucket = int(got["bucket%d" % i])
            pad = np.zeros((bucket - len(x), x.shape[1]), np.float32)
            j = want_jax(jmx.nd.array(np.vstack([x, pad]))).asnumpy()
            np.testing.assert_allclose(got["y%d" % i], j[:len(x)],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["y0"], ranks[0]["y0"])
    held = [int(g["held"]) for g in ranks]
    full = sum(p.nbytes for p in ps)
    assert held[0] == held[1] < 0.6 * full
