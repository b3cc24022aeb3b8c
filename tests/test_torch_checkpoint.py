""".params files, checkpoints and exports across the two packages.

- ``nd.save``/``nd.load``: files written by the JAX package load in the
  port and the other way round, for every dtype with a reference type
  flag that the JAX package holds (float32, float16, uint8, int32,
  int8; without jax's x64 mode it narrows 64-bit arrays), bfloat16
  (promoted to float32) and 0-d arrays (written as shape (1,)); the same
  dict gives byte-identical files. The port keeps float64 and int64
  under their own flags. Row-sparse and CSR entries load as the port's
  sparse arrays.
- ResNet-18 v1 (thumbnail, 32x32, 8 classes) exported by the JAX
  package runs through the port's ``SymbolBlock.imports`` and
  ``InferenceServer.from_checkpoint``; the port's export of the same
  weights loads in the JAX package. Logits agree within rtol 1e-4 of the
  largest logit (fp32, convolutions summed in different orders).
- The JAX package's ``from_checkpoint`` test (tests/test_serving.py:
  337-362): a SoftmaxOutput MLP checkpoint served through the port,
  against the JAX Executor's forward, rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import params_from_numpy
from mxnet_tpu_torch.serving import InferenceServer

torch.set_num_threads(2)

DTYPES = ["float32", "float16", "uint8", "int32", "int8"]


def _arrays(seed):
    rng = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 4), (5,), (2, 1, 3), (1,)][i % 4]
        out["a%d_%s" % (i, dt)] = (rng.randn(*shape) * 50).astype(dt)
    out["scalar"] = np.array(2.5, np.float32)
    return out


def _with_port(arrays):
    with mx.cpu():
        return {k: mx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}


def _as_numpy(loaded):
    if isinstance(loaded, dict):
        return {k: v.asnumpy() for k, v in loaded.items()}
    return [v.asnumpy() for v in loaded]


def _want(a):
    return a.reshape(1) if a.ndim == 0 else a


@pytest.mark.parametrize("as_list", [False, True])
def test_params_files_are_byte_identical(tmp_path, as_list):
    arrays = _arrays(0)
    jdata = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    pdata = _with_port(arrays)
    if as_list:
        jdata, pdata = list(jdata.values()), list(pdata.values())
    jmx.nd.save(str(tmp_path / "jax.params"), jdata)
    mx.nd.save(str(tmp_path / "port.params"), pdata)
    assert (tmp_path / "jax.params").read_bytes() == \
        (tmp_path / "port.params").read_bytes()


def test_jax_written_params_load_in_port(tmp_path):
    arrays = _arrays(1)
    fname = str(tmp_path / "w.params")
    jmx.nd.save(fname, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    got = _as_numpy(mx.nd.load(fname, ctx=mx.cpu()))
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], _want(v))


def test_port_written_params_load_in_jax(tmp_path):
    arrays = _arrays(2)
    fname = str(tmp_path / "w.params")
    mx.nd.save(fname, list(_with_port(arrays).values()))
    got = _as_numpy(jmx.nd.load(fname))
    for g, v in zip(got, arrays.values()):
        assert g.dtype == v.dtype
        np.testing.assert_array_equal(g, _want(v))


def test_64_bit_dtypes_keep_their_flags(tmp_path):
    arrays = {"d": np.random.RandomState(6).randn(3, 2),
              "l": np.arange(-3, 3, dtype=np.int64) * (2 ** 40)}
    fname = str(tmp_path / "w.params")
    mx.nd.save(fname, _with_port(arrays))
    got = _as_numpy(mx.nd.load(fname, ctx=mx.cpu()))
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    # the JAX package reads them, narrowed to its 32-bit types
    jgot = _as_numpy(jmx.nd.load(fname))
    np.testing.assert_allclose(jgot["d"], arrays["d"], rtol=1e-7)


def test_bfloat16_is_saved_as_float32_by_both(tmp_path):
    x = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    jmx.nd.save(str(tmp_path / "j.params"),
                {"w": jmx.nd.array(x).astype("bfloat16")})
    with mx.cpu():
        mx.nd.save(str(tmp_path / "p.params"),
                   {"w": mx.nd.array(x).astype("bfloat16")})
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "p.params").read_bytes()
    got = mx.nd.load(str(tmp_path / "j.params"), ctx=mx.cpu())["w"]
    assert got.dtype == np.float32


def test_sparse_entry_raises(tmp_path):
    # The JAX-written row-sparse entry loads bit for bit (the name is
    # kept from when it raised).
    from mxnet_tpu.ndarray import sparse as jsparse

    dense = np.zeros((4, 3), np.float32)
    dense[1] = 1.0
    dense[3] = -2.5
    fname = str(tmp_path / "s.params")
    jmx.nd.save(fname, {"rs": jsparse.row_sparse_array(dense)})
    got = mx.nd.load(fname, ctx=mx.cpu())["rs"]
    assert got.stype == "row_sparse" and got.shape == (4, 3)
    np.testing.assert_array_equal(got.indices.asnumpy(), [1, 3])
    np.testing.assert_array_equal(got.asnumpy(), dense)


def test_invalid_file_raises(tmp_path):
    fname = tmp_path / "bad.params"
    fname.write_bytes(b"\x00" * 12)
    with pytest.raises(ValueError, match="invalid NDArray file"):
        mx.nd.load(str(fname), ctx=mx.cpu())


# -- exports ------------------------------------------------------------------

_REF = {}


def _jax_resnet(tmp_path_factory):
    """(jax net, input, eval logits, export prefix), once per worker."""
    if not _REF:
        rng = np.random.RandomState(0)
        net = jvision.resnet18_v1(classes=8, thumbnail=True)
        net.initialize()
        x = rng.rand(3, 3, 32, 32).astype(np.float32)
        with jmx.autograd.pause():
            net(jmx.nd.array(x))
        for name, p in net.collect_params().items():
            if name.endswith("running_var"):
                p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
            elif name.endswith(("running_mean", "beta", "gamma")):
                p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
        with jmx.autograd.pause():
            want = net(jmx.nd.array(x)).asnumpy()
        prefix = str(tmp_path_factory.mktemp("jax_export") / "resnet18")
        net.export(prefix)
        _REF.update(net=net, x=x, want=want, prefix=prefix)
    return _REF


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_jax_export_runs_in_port_symbolblock(tmp_path_factory):
    ref = _jax_resnet(tmp_path_factory)
    with mx.cpu():
        blk = mx.gluon.SymbolBlock.imports(ref["prefix"] + "-symbol.json",
                                           "data",
                                           ref["prefix"] + "-0000.params")
        got = blk(mx.nd.array(ref["x"])).asnumpy()
    _close(got, ref["want"])


def test_jax_export_served_from_checkpoint(tmp_path_factory):
    ref = _jax_resnet(tmp_path_factory)
    with InferenceServer.from_checkpoint(
            ref["prefix"], 0, item_shape=(3, 32, 32), buckets=(1, 4),
            max_delay_ms=1, ctx=mx.cpu()) as srv:
        assert srv.compile_count == 2
        got = srv.predict(ref["x"]).asnumpy()
        one = srv.predict(ref["x"][1:2]).asnumpy()
    _close(got, ref["want"])
    _close(one, ref["want"][1:2])


def test_port_export_loads_in_jax(tmp_path_factory, tmp_path):
    ref = _jax_resnet(tmp_path_factory)
    jnet = ref["net"]
    with mx.cpu():
        net = vision.resnet18_v1(classes=8, thumbnail=True)
        net.initialize()
        params_from_numpy(net, {n: p.data().asnumpy() for n, p in
                                jnet.collect_params().items()},
                          prefix=jnet.prefix)
        net.hybridize()
        net(mx.nd.array(ref["x"]))
        sym_file, params_file = net.export(str(tmp_path / "port"), epoch=3)
    assert params_file.endswith("-0003.params")
    blk = jmx.gluon.SymbolBlock.imports(sym_file, "data", params_file)
    got = blk(jmx.nd.array(ref["x"])).asnumpy()
    _close(got, ref["want"])
    keys = set(jmx.nd.load(params_file))
    assert any(k.startswith("aux:") and k.endswith("running_var")
               for k in keys)
    assert all(k.startswith(("arg:", "aux:")) for k in keys)


def test_export_stablehlo_raises():
    with mx.cpu():
        net = mx.gluon.nn.Dense(3)
    with pytest.raises(NotImplementedError, match="export"):
        net.export_stablehlo("unused")


def _mlp(F):
    data = F.sym.var("data")
    net = F.sym.FullyConnected(data, num_hidden=6, name="fc1")
    net = F.sym.Activation(net, act_type="relu", name="relu1")
    net = F.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return F.sym.SoftmaxOutput(net, name="softmax")


def test_from_checkpoint_matches_jax_direct_forward(tmp_path):
    rng = np.random.RandomState(4)
    args = {"fc1_weight": rng.randn(6, 4).astype(np.float32) * 0.5,
            "fc1_bias": np.zeros((6,), np.float32),
            "fc2_weight": rng.randn(3, 6).astype(np.float32) * 0.5,
            "fc2_bias": np.zeros((3,), np.float32)}
    x = rng.rand(5, 4).astype(np.float32)
    jnet = _mlp(jmx)
    feed = {k: jmx.nd.array(v) for k, v in args.items()}
    feed.update(data=jmx.nd.array(x), softmax_label=jmx.nd.zeros((5,)))
    want = jnet.bind(jmx.cpu(), feed).forward(is_train=False)[0].asnumpy()

    prefix = str(tmp_path / "mlp")
    with mx.cpu():
        mx.model.save_checkpoint(prefix, 0, _mlp(mx),
                                 {k: mx.nd.array(v) for k, v in args.items()},
                                 {})
    with InferenceServer.from_checkpoint(prefix, 0, item_shape=(4,),
                                         buckets=(1, 8), max_delay_ms=5,
                                         ctx=mx.cpu()) as srv:
        got = srv.predict(x)
        assert srv.compile_count == len(srv.policy.buckets)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5)


def test_checkpoint_round_trip_between_packages(tmp_path):
    rng = np.random.RandomState(5)
    args = {"fc1_weight": rng.randn(6, 4).astype(np.float32),
            "fc1_bias": rng.randn(6).astype(np.float32),
            "fc2_weight": rng.randn(3, 6).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}
    jprefix = str(tmp_path / "jax")
    jmx.model.save_checkpoint(jprefix, 7, _mlp(jmx),
                              {k: jmx.nd.array(v) for k, v in args.items()},
                              {})
    sym, arg_params, aux_params = mx.model.load_checkpoint(jprefix, 7,
                                                           ctx=mx.cpu())
    assert sym.tojson() == _mlp(jmx).tojson()
    assert aux_params == {}
    for k, v in args.items():
        np.testing.assert_array_equal(arg_params[k].asnumpy(), v)
    pprefix = str(tmp_path / "port")
    mx.model.save_checkpoint(pprefix, 7, sym, arg_params, aux_params)
    for suffix in ("-symbol.json", "-0007.params"):
        with open(jprefix + suffix, "rb") as a, open(pprefix + suffix,
                                                     "rb") as b:
            assert a.read() == b.read(), suffix


def test_symbolblock_trains_like_jax(tmp_path):
    """An imported graph under autograd.record(): the imperative walk
    records every node; gradients and BatchNorm's train-mode statistics
    match the JAX SymbolBlock (fp32, rtol 1e-5 / atol 1e-6)."""
    def build(F):
        data = F.sym.var("data")
        x = F.sym.Convolution(data, kernel=(3, 3), num_filter=3, pad=(1, 1),
                              name="conv")
        x = F.sym.BatchNorm(x, fix_gamma=False, eps=1e-5, name="bn")
        x = F.sym.Activation(x, act_type="relu", name="relu")
        return F.sym.FullyConnected(x, num_hidden=4, name="fc")

    rng = np.random.RandomState(7)
    sym = build(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(2, 2, 5, 5))
    args = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    aux = {"bn_moving_mean": np.zeros(aux_shapes[0], np.float32),
           "bn_moving_var": np.ones(aux_shapes[1], np.float32)}
    prefix = str(tmp_path / "net")
    jmx.model.save_checkpoint(prefix, 0, sym,
                              {k: jmx.nd.array(v) for k, v in args.items()},
                              {k: jmx.nd.array(v) for k, v in aux.items()})
    x = rng.randn(2, 2, 5, 5).astype(np.float32)

    jblk = jmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                         prefix + "-0000.params")
    with jmx.autograd.record():
        jout = jblk(jmx.nd.array(x))
        (jout * jout).sum().backward()
    with mx.cpu():
        blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                           prefix + "-0000.params")
        with mx.autograd.record():
            out = blk(mx.nd.array(x))
            (out * out).sum().backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    jparams, params = jblk.collect_params(), blk.collect_params()
    for name in args:
        np.testing.assert_allclose(params[name].grad().asnumpy(),
                                   jparams[name].grad().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in aux:
        got = params[name].data().asnumpy()
        np.testing.assert_allclose(got, jparams[name].data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert not np.allclose(got, aux[name])
