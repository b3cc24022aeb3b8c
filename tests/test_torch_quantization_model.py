"""``contrib.quantization`` of the port against the JAX package's, on the
same numpy inputs.

- ``_get_optimal_threshold`` and ``_quantize_weight`` (numpy on the host
  in both packages): bit for bit;
- ``quantize_model`` over tests/test_quantization.py's LeNet and a
  ``resnet18_v1`` at 32x32, b2, weights crossing as ``.params`` files:
  the int8 weights and their ``w_scale`` bit for bit, the ``qargs``
  ``.params`` file byte for byte; naive ranges within rtol 1e-5 (LeNet)
  and 1e-4 (ResNet: its activations come from two packages' float32
  convolutions); entropy thresholds within one histogram bin
  (2 amax / 2001, where one float32 rounding of an activation can move
  a value across a bin edge); ``qsym.tojson()`` the JAX package's once
  those floats are compared so;
- the JAX-written quantized checkpoint served by the port
  (``InferenceServer.from_checkpoint``) against the JAX package's
  outputs (the limit is stated at the test);
- the LeNet accuracy acceptance of tests/test_quantization.py on the port;
- ``calib_mode="none"`` leaves both packages' graphs unquantized;
- ties: scaled values on exact halves round half to even through
  ``_contrib_quantize``, ``_contrib_quantize_v2`` and
  ``_quantize_weight``, bit for bit the JAX package's;
- int8 parameters through ``Module.set_params`` and
  ``save_checkpoint``/``load_checkpoint``: int8 (type flag 5) in the
  file, byte for byte the JAX package's file.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq

torch.set_num_threads(2)

C = mx.cpu()
NAIVE_RTOL = {"lenet": 1e-5, "resnet": 1e-4}


def _lenet_data():
    """tests/test_quantization.py's synthetic 4-class images."""
    rng = np.random.RandomState(42)
    n = 400
    X = (rng.rand(n, 1, 12, 12) * 0.3).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    quads = [(slice(0, 6), slice(0, 6)), (slice(0, 6), slice(6, 12)),
             (slice(6, 12), slice(0, 6)), (slice(6, 12), slice(6, 12))]
    for i in range(n):
        r, c = quads[int(y[i])]
        X[i, 0, r, c] += 1.0
    return X, y


def _lenet_sym(m):
    data = m.sym.var("data")
    c1 = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="c1")
    a1 = m.sym.Activation(c1, act_type="relu", name="a1")
    p1 = m.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    f1 = m.sym.FullyConnected(p1, num_hidden=32, name="f1")
    a2 = m.sym.Activation(f1, act_type="relu", name="a2")
    f2 = m.sym.FullyConnected(a2, num_hidden=4, name="f2")
    return m.sym.SoftmaxOutput(f2, name="softmax")


def _lenet_params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"c1_weight": (8, 1, 3, 3), "c1_bias": (8,),
              "f1_weight": (32, 200), "f1_bias": (32,),
              "f2_weight": (4, 32), "f2_bias": (4,)}
    return {k: (rng.standard_normal(s) * (0.5 if len(s) > 1 else 0.1))
            .astype(np.float32) for k, s in shapes.items()}


def _iters(X, y, batch):
    """The same calibration batches in both packages."""
    return (jmx.io.NDArrayIter(X, y, batch_size=batch,
                               label_name="softmax_label"),
            mx.io.NDArrayIter(X, y, batch_size=batch,
                              label_name="softmax_label", ctx=C))


def _quantize_both(sym_pair, args, aux, X, y, mode, batch, n=None,
                   label_names=("softmax_label",)):
    jit, tit = _iters(X, y, batch)
    jargs = {k: jmx.nd.array(v) for k, v in args.items()}
    jaux = {k: jmx.nd.array(v) for k, v in aux.items()}
    targs = {k: mx.nd.array(v, ctx=C) for k, v in args.items()}
    taux = {k: mx.nd.array(v, ctx=C) for k, v in aux.items()}
    jout = jq.quantize_model(sym_pair[0], jargs, jaux, calib_mode=mode,
                             calib_data=jit, num_calib_examples=n,
                             label_names=label_names, ctx=jmx.cpu())
    tout = tq.quantize_model(sym_pair[1], targs, taux, calib_mode=mode,
                             calib_data=tit, num_calib_examples=n,
                             label_names=label_names, ctx=C)
    return jout, tout


def _quantized_attrs(qsym):
    return {n["name"]: n["attrs"] for n in json.loads(qsym.tojson())["nodes"]
            if n["name"].endswith("_quantized")}


def _hold_json(jq_sym, tq_sym, rtol, atol_of):
    """The two graphs' JSON equal, the calibrated floats within `rtol`
    (and `atol_of(node)` absolute)."""
    jn, tn = json.loads(jq_sym.tojson()), json.loads(tq_sym.tojson())
    assert jn["heads"] == tn["heads"]
    assert len(jn["nodes"]) == len(tn["nodes"])
    for a, b in zip(jn["nodes"], tn["nodes"]):
        a, b = dict(a), dict(b)
        fa, fb = a.pop("attrs"), b.pop("attrs")
        assert a == b
        assert sorted(fa) == sorted(fb)
        for k in fa:
            if k in ("min_data", "max_data"):
                np.testing.assert_allclose(fb[k], fa[k], rtol=rtol,
                                           atol=atol_of(a["name"]),
                                           err_msg=a["name"] + " " + k)
            else:
                assert fa[k] == fb[k], (a["name"], k)


def _hold_qargs(jqargs, tqargs, tmp_path):
    assert sorted(jqargs) == sorted(tqargs)
    for k in jqargs:
        assert str(tqargs[k].dtype) == str(jqargs[k].dtype), k
        np.testing.assert_array_equal(tqargs[k].asnumpy(),
                                      np.asarray(jqargs[k].asnumpy()))
    jmx.nd.save(str(tmp_path / "j.params"), jqargs)
    mx.nd.save(str(tmp_path / "t.params"), tqargs)
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()


# -- the host numpy halves, bit for bit --------------------------------------

@pytest.mark.parametrize("kind", ["gaussian_outlier", "relu", "uniform",
                                  "constant"])
def test_optimal_threshold_is_the_jax_packages(kind):
    rng = np.random.RandomState(3)
    arr = {"gaussian_outlier": np.concatenate([rng.randn(50000),
                                               np.array([50.0])]),
           "relu": np.maximum(rng.randn(40000) * 2, 0).astype(np.float32),
           "uniform": rng.rand(30000).astype(np.float32) * 6 - 2,
           "constant": np.full(100, 0.25, np.float32)}[kind]
    assert tq._get_optimal_threshold(arr) == jq._get_optimal_threshold(arr)


def test_quantize_weight_is_the_jax_packages():
    rng = np.random.default_rng(1)
    for w in (rng.standard_normal((16, 8, 3, 3)).astype(np.float32),
              rng.standard_normal((10, 64)).astype(np.float32) * 1e-3,
              np.zeros((4, 4), np.float32)):
        tw, ts = tq._quantize_weight(mx.nd.array(w, ctx=C))
        jw, js = jq._quantize_weight(jmx.nd.array(w))
        assert ts == js and str(tw.dtype) == "int8"
        np.testing.assert_array_equal(tw.asnumpy(), np.asarray(jw.asnumpy()))


def test_ties_round_half_to_even_in_both_packages():
    """Scaled values on exact halves (scale 1: a range of +-127) round
    half to even through the three quantizers, as ``jnp.round`` and
    ``np.round`` do. The reference's rule (src/operator/quantization/)
    is not in this repository; ROADMAP Queue 3 says what changes if it
    rounds half away from zero."""
    halves = np.array([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, 126.5],
                      np.float32)
    even = np.array([2, -2, 4, -4, 0, 0, 2, 126], np.int8)
    lo, hi = np.array([-127.0], np.float32), np.array([127.0], np.float32)
    got = mx.nd._contrib_quantize(mx.nd.array(halves, ctx=C),
                                  mx.nd.array(lo, ctx=C),
                                  mx.nd.array(hi, ctx=C))[0].asnumpy()
    want = np.asarray(jmx.nd._contrib_quantize(
        jmx.nd.array(halves), jmx.nd.array(lo),
        jmx.nd.array(hi))[0].asnumpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, even)
    got = mx.nd._contrib_quantize_v2(
        mx.nd.array(halves, ctx=C), min_calib_range=-127.0,
        max_calib_range=127.0)[0].asnumpy()
    want = np.asarray(jmx.nd._contrib_quantize_v2(
        jmx.nd.array(halves), min_calib_range=-127.0,
        max_calib_range=127.0)[0].asnumpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, even)
    w = np.append(halves, np.float32(127.0))      # amax 127: scale 1
    tw, ts = tq._quantize_weight(mx.nd.array(w, ctx=C))
    jw, js = jq._quantize_weight(jmx.nd.array(w))
    assert ts == js == 1.0
    np.testing.assert_array_equal(tw.asnumpy(), np.asarray(jw.asnumpy()))
    np.testing.assert_array_equal(tw.asnumpy()[:-1], even)


# -- quantize_model on LeNet ---------------------------------------------------

@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_lenet_quantize_model_matches_jax(mode, tmp_path):
    X, y = _lenet_data()
    params = _lenet_params()
    (jsym, jqargs, jqaux), (tsym, tqargs, tqaux) = _quantize_both(
        (_lenet_sym(jmx), _lenet_sym(mx)), params, {}, X[:100], y[:100],
        mode, 50, n=100)
    _hold_qargs(jqargs, tqargs, tmp_path)
    # Every Convolution and FullyConnected became its int8 node.
    assert sorted(_quantized_attrs(tsym)) == [
        "c1_quantized", "f1_quantized", "f2_quantized"]
    if mode == "naive":
        _hold_json(jsym, tsym, NAIVE_RTOL["lenet"], lambda name: 0.0)
    else:
        bins = {n: 2 * max(abs(a["min_data"]), abs(a["max_data"])) / 2001
                for n, a in _quantized_attrs(jsym).items()}
        _hold_json(jsym, tsym, 0.0, lambda name: bins.get(name, 0.0))


def test_calib_mode_none_leaves_both_graphs_unquantized():
    X, y = _lenet_data()
    params = _lenet_params()
    (jsym, jqargs, _), (tsym, tqargs, _) = _quantize_both(
        (_lenet_sym(jmx), _lenet_sym(mx)), params, {}, X[:50], y[:50],
        "none", 50)
    assert not _quantized_attrs(jsym) and not _quantized_attrs(tsym)
    assert tsym.tojson() == _lenet_sym(mx).tojson()
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert sorted(tqargs) == sorted(jqargs) == sorted(params)
    assert all(str(v.dtype) == "float32" for v in tqargs.values())


def test_lenet_int8_accuracy_within_one_point_of_fp32():
    """tests/test_quantization.py's acceptance, on the port."""
    X, y = _lenet_data()
    with mx.cpu():
        mx.random.seed(7)
        train = mx.io.NDArrayIter(X[:300], y[:300], batch_size=50,
                                  shuffle=True, label_name="softmax_label",
                                  rng=np.random.RandomState(7))
        test = mx.io.NDArrayIter(X[300:], y[300:], batch_size=50,
                                 label_name="softmax_label")
        mod = mx.mod.Module(_lenet_sym(mx), context=C,
                            label_names=["softmax_label"])
        mod.fit(train, num_epoch=10, optimizer="adam",
                optimizer_params={"learning_rate": 0.01})
        fp32 = mod.score(test, mx.metric.Accuracy())[0][1]
        assert fp32 > 0.7, fp32
        arg, aux = mod.get_params()
        calib = mx.io.NDArrayIter(X[:100], y[:100], batch_size=50,
                                  label_name="softmax_label")
        qsym, qargs, qaux = tq.quantize_model(
            mod.symbol, arg, aux, calib_mode="naive", calib_data=calib,
            num_calib_examples=100)
        assert any(str(v.dtype) == "int8" for v in qargs.values())
        qmod = mx.mod.Module(qsym, context=C, label_names=["softmax_label"])
        test.reset()
        qmod.bind(data_shapes=test.provide_data,
                  label_shapes=test.provide_label, for_training=False)
        qmod.set_params(qargs, qaux, allow_missing=False)
        test.reset()
        q = qmod.score(test, mx.metric.Accuracy())[0][1]
    assert abs(fp32 - q) <= 0.01 + 1e-9, (q, fp32)


def test_int8_params_keep_their_type_in_the_checkpoint(tmp_path):
    """``model.save_checkpoint`` writes an int8 ``qargs`` entry with type
    flag 5 and ``load_checkpoint`` gives it back int8, byte for byte the
    JAX package's file; ``Module.set_params`` takes it into the
    Module's float32 argument (the port's ``infer_type`` is all float32,
    as the JAX package's) with the same values, and the forward is the
    one from the int8 arrays."""
    X, y = _lenet_data()
    params = _lenet_params()
    (jsym, jqargs, _), (tsym, tqargs, _) = _quantize_both(
        (_lenet_sym(jmx), _lenet_sym(mx)), params, {}, X[:50], y[:50],
        "naive", 50)
    jmx.model.save_checkpoint(str(tmp_path / "j"), 0, jsym, jqargs, {})
    mx.model.save_checkpoint(str(tmp_path / "t"), 0, tsym, tqargs, {})
    jb = (tmp_path / "j-0000.params").read_bytes()
    tb = (tmp_path / "t-0000.params").read_bytes()
    assert jb == tb
    # nd.save's record of c1's int8 weight: the dtype flag after the
    # shape (mxnet_tpu_torch/ndarray/utils.py: 5 is int8).
    assert (5).to_bytes(4, "little") in tb
    sym, args, _ = mx.model.load_checkpoint(str(tmp_path / "t"), 0, ctx=C)
    assert str(args["c1_quantized_weight"].dtype) == "int8"
    np.testing.assert_array_equal(args["c1_quantized_weight"].asnumpy(),
                                  tqargs["c1_quantized_weight"].asnumpy())
    with mx.cpu():
        mod = mx.mod.Module(sym, context=C, label_names=["softmax_label"])
        mod.bind(data_shapes=[("data", (50, 1, 12, 12))],
                 label_shapes=[("softmax_label", (50,))],
                 for_training=False)
        mod.set_params(args, {}, allow_missing=False)
        got, _ = mod.get_params()
        np.testing.assert_array_equal(
            got["c1_quantized_weight"].asnumpy(),
            args["c1_quantized_weight"].asnumpy().astype(np.float32))
        batch = mx.io.DataBatch([mx.nd.array(X[:50], ctx=C)],
                                [mx.nd.array(y[:50], ctx=C)])
        mod.forward(batch, is_train=False)
        out = mod.get_outputs()[0].asnumpy()
    ex = sym.bind(C, {**args, "data": mx.nd.array(X[:50], ctx=C),
                      "softmax_label": mx.nd.array(y[:50], ctx=C)},
                  grad_req="null")
    np.testing.assert_array_equal(out, ex.forward()[0].asnumpy())


# -- quantize_model on resnet18_v1 --------------------------------------------

@pytest.fixture(scope="module")
def resnet_export(tmp_path_factory):
    """resnet18_v1 (10 classes) at 32x32, random BatchNorm statistics,
    exported by the port; both packages read the files."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    tmp = tmp_path_factory.mktemp("r18")
    with mx.cpu():
        mx.random.seed(0)
        net = vision.resnet18_v1(classes=10)
        net.initialize(mx.init.Xavier(magnitude=2), ctx=C)
        net(mx.nd.zeros((1, 3, 32, 32), ctx=C))
        rng = np.random.default_rng(4)
        for name, p in net.collect_params().items():
            if name.endswith(("running_var", "gamma")):
                p.set_data(rng.uniform(0.8, 1.2, p.shape).astype(np.float32))
            elif name.endswith(("running_mean", "beta")):
                p.set_data(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))
        net.hybridize()
        net(mx.nd.zeros((1, 3, 32, 32), ctx=C))
        prefix = str(tmp / "r18")
        net.export(prefix)
    _, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=C)
    rng = np.random.default_rng(5)
    X = rng.random((4, 3, 32, 32), dtype=np.float32)
    return {"prefix": prefix, "X": X, "y": np.zeros(4, np.float32),
            "args": {k: v.asnumpy() for k, v in args.items()},
            "aux": {k: v.asnumpy() for k, v in aux.items()}}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_resnet18_quantize_model_matches_jax(mode, resnet_export, tmp_path):
    r = resnet_export
    jsym = jmx.sym.load(r["prefix"] + "-symbol.json")
    tsym = mx.sym.load(r["prefix"] + "-symbol.json")
    (jqs, jqargs, jqaux), (tqs, tqargs, tqaux) = _quantize_both(
        (jsym, tsym), r["args"], r["aux"], r["X"], r["y"], mode, 2,
        label_names=())
    _hold_qargs(jqargs, tqargs, tmp_path)
    # 20 convolutions (17 3x3 + 3 downsample 1x1) and the classifier.
    assert len(_quantized_attrs(tqs)) == 21
    if mode == "naive":
        _hold_json(jqs, tqs, NAIVE_RTOL["resnet"], lambda name: 0.0)
    else:
        bins = {n: 2 * max(abs(a["min_data"]), abs(a["max_data"])) / 2001
                for n, a in _quantized_attrs(jqs).items()}
        _hold_json(jqs, tqs, 0.0, lambda name: bins.get(name, 0.0))
    if mode == "naive":
        _serve_jax_checkpoint(jqs, jqargs, jqaux, r, tmp_path)


def _serve_jax_checkpoint(jqs, jqargs, jqaux, r, tmp_path):
    """The JAX-written int8 checkpoint served by the port against the
    JAX package's forward of the same files. Both contract exactly
    (int32 accumulators); they differ only where a float32 rounding
    before a requantization (XLA fuses a bias add into an FMA, the port
    rounds twice) moves an activation across a rounding edge, which
    changes one int8 value by one step. Limit: 1e-3 of the largest
    logit, about ten such flips in a logit's path (one flip moves a
    logit by one activation step times one weight, ~1e-4 of it here);
    the typical reading is 0."""
    from mxnet_tpu_torch import serving

    prefix = str(tmp_path / "q")
    jmx.model.save_checkpoint(prefix, 0, jqs, jqargs, jqaux)
    X = r["X"]
    _, jargs, jaux = jmx.model.load_checkpoint(prefix, 0)
    jargs = dict(jargs, data=jmx.nd.array(X))
    want = np.asarray(jqs.bind(jmx.cpu(), jargs, aux_states=jaux,
                               grad_req="null").forward()[0].asnumpy())
    srv = serving.InferenceServer.from_checkpoint(
        prefix, 0, item_shape=X.shape[1:], buckets=(4,), ctx=C)
    try:
        got = srv.predict(X).asnumpy()
    finally:
        srv.shutdown()
    scale = float(np.abs(want).max())
    assert got.shape == want.shape == (4, 10)
    assert np.abs(got - want).max() <= 1e-3 * scale, \
        (np.abs(got - want).max(), scale)
