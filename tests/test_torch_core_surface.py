"""The core surface of the port against the JAX package: NDArray's
methods and the ``nd`` module functions, elementwise ``==``/``!=``,
``Block.name_scope``, ``gluon.Constant`` and ``ParameterDict``'s
``get_constant``/``save``/``load``/``reset_ctx``, ``gluon.utils``, the
initializers, the symbol rules of LayerNorm, InstanceNorm, Deconvolution
and the regression outputs, and ``Context.empty_cache``.

The same numpy inputs go through both packages (the port with
``ctx=mx.cpu()``); fp32, rtol 1e-5 / atol 1e-6 where values are compared,
exact where the computation is (files, deterministic initializers,
indices). The random initializers are held to their laws. The port's
``round``/``rint``/``make_loss`` follow the reference where the JAX
package does not (ROADMAP Queue 3); those cases are held to the
reference's definition here, on the host and (``cuda`` marker) the card.
"""
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import relative_names

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _both(fn):
    """fn(pkg, arr) with each package; returns (jax, port)."""
    want = fn(jmx, jmx.nd.array)
    with mx.cpu():
        got = fn(mx, lambda a, **k: mx.nd.array(a, ctx=mx.cpu(), **k))
    return want, got


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


R = np.random.RandomState(3)
X = (R.permutation(24).astype(np.float32) * 0.7 - 8).reshape(2, 3, 4)
IDX = np.array([0, 2, 1], np.float32)

# method -> fn(array, arr) of an NDArray `a` (X) and the array maker.
METHODS = {
    "T": lambda a, arr: a.T,
    "reshape_like": lambda a, arr: a.reshape_like(arr(np.zeros((6, 4)))),
    "squeeze": lambda a, arr: a.reshape(2, 1, 12).squeeze(axis=1),
    "expand_dims": lambda a, arr: a.expand_dims(1),
    "broadcast_to": lambda a, arr: a[:, :1].broadcast_to((2, 5, 4)),
    "broadcast_like": lambda a, arr: a[:1].broadcast_like(a),
    "swapaxes": lambda a, arr: a.swapaxes(0, 2),
    "split": lambda a, arr: a.split(2, axis=2),
    "slice_axis": lambda a, arr: a.slice_axis(2, 1, 3),
    "take": lambda a, arr: a.take(arr(IDX[:2]), axis=1),
    "one_hot": lambda a, arr: arr(IDX).one_hot(4, on_value=3.0),
    "pick": lambda a, arr: a[0].pick(arr(IDX), axis=1),
    "tile": lambda a, arr: a.tile((2, 1, 1)),
    "repeat": lambda a, arr: a.repeat(2, axis=1),
    "pad": lambda a, arr: a.reshape(1, 2, 3, 4).pad(
        pad_width=(0, 0, 0, 0, 1, 1, 2, 0), constant_value=1.0),
    "clip": lambda a, arr: a.clip(-3, 2),
    "abs": lambda a, arr: a.abs(),
    "sign": lambda a, arr: a.sign(),
    "round": lambda a, arr: (a * 0.3).round(),
    "sqrt": lambda a, arr: a.abs().sqrt(),
    "square": lambda a, arr: a.square(),
    "exp": lambda a, arr: (a * 0.1).exp(),
    "log": lambda a, arr: (a.abs() + 1).log(),
    "sigmoid": lambda a, arr: a.sigmoid(),
    "relu": lambda a, arr: a.relu(),
    "tanh": lambda a, arr: a.tanh(),
    "softmax": lambda a, arr: a.softmax(axis=1),
    "log_softmax": lambda a, arr: a.log_softmax(),
    "sum": lambda a, arr: a.sum(axis=[0, 2]),
    "mean": lambda a, arr: a.mean(axis=1, keepdims=True),
    "max": lambda a, arr: a.max(axis=(0, 1)),
    "min": lambda a, arr: a.min(),
    "prod": lambda a, arr: (a * 0.1).prod(axis=2),
    "norm": lambda a, arr: a.norm(axis=1),
    "argmax": lambda a, arr: a.argmax(axis=2),
    "argmin": lambda a, arr: a.argmin(),
    "argsort": lambda a, arr: a.argsort(axis=1, is_ascend=False),
    "topk": lambda a, arr: a.topk(axis=2, k=2, ret_typ="both"),
    "sort": lambda a, arr: a.sort(axis=0),
    "dot": lambda a, arr: a[0].dot(a[1].T),
    "mod": lambda a, arr: a % 3.0,
    "rmod": lambda a, arr: 7.0 % (a.abs() + 1),
    "mod_array": lambda a, arr: a % (a[0].abs() + 1),
    "pow": lambda a, arr: a.abs() ** 1.5,
    "rpow": lambda a, arr: 2.0 ** (a * 0.1),
    "eq": lambda a, arr: a == a.round(),
    "ne_scalar": lambda a, arr: a != 2.4,
    "iter": lambda a, arr: list(a),
    "getitem": lambda a, arr: a[1, :, 2:],
    "item": lambda a, arr: a[0, 0, 0].item(),
    "int": lambda a, arr: int(a[1, 2, 3]),
    "astype": lambda a, arr: a.astype("int32"),
    "as_in_ctx": lambda a, arr: a.as_in_ctx(a.context),
    "as_nd_ndarray": lambda a, arr: a.as_nd_ndarray(),
    "tostype": lambda a, arr: a.tostype("default"),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method_equals_jax(name):
    want, got = _both(lambda pkg, arr: _np(METHODS[name](arr(X), arr)))
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        assert np.shape(got) == np.shape(want)
        _close(got, want)


def test_flip_and_stype_and_tobytes():
    with mx.cpu():
        a = mx.nd.array(X, ctx=mx.cpu())
        np.testing.assert_array_equal(a.flip(1).asnumpy(), X[:, ::-1])
        assert a.stype == "default"
        assert a.tobytes() == X.tobytes()
        # Sparse storage types cast through nd.sparse; an unknown one
        # raises.
        x2 = mx.nd.array(X.reshape(X.shape[0], -1), ctx=mx.cpu())
        csr = x2.tostype("csr")
        assert csr.stype == "csr" and csr.shape == x2.shape
        np.testing.assert_array_equal(csr.asnumpy(), x2.asnumpy())
        assert x2.tostype("row_sparse").stype == "row_sparse"
        with pytest.raises(ValueError):
            a.tostype("nope")


FUNCTIONS = {
    "arange": lambda nd: nd.arange(1.0, 4.0, 0.3),
    "arange_stop": lambda nd: nd.arange(5),
    "arange_repeat": lambda nd: nd.arange(0, 6, 2, repeat=3),
    "arange_int": lambda nd: nd.arange(-3, 7, 2, dtype="int32"),
    "linspace": lambda nd: nd.linspace(-1.0, 2.0, 7),
    "linspace_open": lambda nd: nd.linspace(0.0, 1.0, 5, endpoint=False),
    "eye": lambda nd: nd.eye(3),
    "eye_rect": lambda nd: nd.eye(3, 5, k=-1),
    "full": lambda nd: nd.full((2, 3), 2.5),
    "empty": lambda nd: nd.empty((2, 2)),
    "moveaxis": lambda nd: nd.moveaxis(nd.array(X), 0, 2),
    "concat": lambda nd: nd.concat(nd.array(X), nd.array(X), dim=2),
    "stack": lambda nd: nd.stack(nd.array(X), nd.array(X), axis=1),
    "split": lambda nd: nd.split(nd.array(X), num_outputs=3, axis=1),
    "slice": lambda nd: nd.slice(nd.array(X), begin=(0, 1, None),
                                 end=(2, 3, None), step=(1, 1, -1)),
    "flip": lambda nd: nd.flip(nd.array(X), axis=2),
    "topk": lambda nd: nd.topk(nd.array(X), axis=1, k=2),
    "batch_dot": lambda nd: nd.batch_dot(nd.array(X), nd.array(X),
                                         transpose_b=True),
    "gather_nd": lambda nd: nd.gather_nd(nd.array(X), nd.array(
        np.array([[1, 0], [2, 1]], np.float32))),
    "broadcast_to": lambda nd: nd.broadcast_to(nd.array(X[:1]),
                                               shape=(3, 3, 4)),
    "one_hot": lambda nd: nd.one_hot(nd.array(IDX), 3),
    "floor": lambda nd: nd.floor(nd.array(X * 0.3)),
    "maximum": lambda nd: nd.maximum(nd.array(X), nd.array(X * -1)),
    "squeeze": lambda nd: nd.squeeze(nd.array(X[:, :1])),
    "tile": lambda nd: nd.tile(nd.array(X), reps=(1, 2)),
    "LayerNorm": lambda nd: nd.LayerNorm(nd.array(X), nd.ones((4,)),
                                         nd.zeros((4,))),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_nd_function_equals_jax(name):
    want = _np(FUNCTIONS[name](jmx.nd))
    with mx.cpu():
        got = _np(FUNCTIONS[name](mx.nd))
    if isinstance(want, list):
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.dtype, want.dtype)
    _close(got, want)


def test_functions_make_on_the_context():
    with mx.cpu():
        for fn in (lambda: mx.nd.arange(3), lambda: mx.nd.eye(2),
                   lambda: mx.nd.linspace(0, 1, 3), lambda: mx.nd.empty(2)):
            assert fn().context == mx.cpu()


# -- == and != ----------------------------------------------------------------

def test_eq_and_ne_are_elementwise_and_count_matches():
    pred = np.array([1, 2, 0, 3, 3], np.float32)
    label = np.array([1, 0, 0, 3, 2], np.float32)

    def fn(pkg, arr):
        p, y = arr(pred), arr(label)
        return ((p == y).sum().asscalar(), (p != y).asnumpy(),
                (p == 3).asnumpy(), (p != 3.0).sum().asscalar())

    want, got = _both(fn)
    assert got[0] == want[0] == 3
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] == 3


def test_ndarrays_hash_and_contain_by_identity():
    with mx.cpu():
        a = mx.nd.array(X, ctx=mx.cpu())
        b = mx.nd.array(X, ctx=mx.cpu())
        s = {a, b}
        assert len(s) == 2 and a in s and b in s
        d = {a: "a", b: "b"}
        assert d[a] == "a" and d[b] == "b"
        assert hash(a) == id(a)
        assert (a == None) is False  # noqa: E711 (no elementwise None)
        # A marked variable may be marked again (the autograd registry
        # keys by id, not by ==).
        a.attach_grad()
        a.attach_grad()
        with mx.autograd.record():
            y = (a * a).sum()
        y.backward()
        _close(a.grad.asnumpy(), 2 * X)


# -- gluon --------------------------------------------------------------------

def _scoped_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(3, in_units=4))
        net.add(pkg.gluon.nn.Dense(2, in_units=3))
    return net


def test_name_scope_names_equal_jax():
    jnet, tnet = _scoped_net(jmx), _scoped_net(mx)
    jnames = list(jnet.collect_params().keys())
    tnames = list(tnet.collect_params().keys())
    assert relative_names(tnames, tnet.prefix) and \
        list(relative_names(tnames, tnet.prefix).values()) == \
        list(relative_names(jnames, jnet.prefix).values())
    # No parent prefix in either package: the scope adds none.
    for names, net in ((jnames, jnet), (tnames, tnet)):
        assert not any(n.startswith(net.prefix) for n in names)


def _pdict(pkg, arrays, ctx=None):
    pd = pkg.gluon.ParameterDict("net_")
    pd.get("w", shape=(3, 4))
    pd.get("b", shape=(4,))
    pd.get_constant("c", arrays["net_c"])
    if ctx is not None:
        pd.initialize(ctx=ctx)
    else:
        pd.initialize()
    for name, p in pd.items():
        p.set_data(arrays[name])
    return pd


def test_constant_and_parameter_dict_files_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    arrays = {"net_w": rng.randn(3, 4).astype(np.float32),
              "net_b": rng.randn(4).astype(np.float32),
              "net_c": rng.randn(2, 2).astype(np.float32)}
    jpd = _pdict(jmx, arrays)
    with mx.cpu():
        tpd = _pdict(mx, arrays, ctx=mx.cpu())
    c = tpd["net_c"]
    assert isinstance(c, mx.gluon.Constant) and c.grad_req == "null"
    np.testing.assert_array_equal(c.data().asnumpy(), arrays["net_c"])
    assert tpd.get_constant("c") is c
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jpd.save(jfile, strip_prefix="net_")
    tpd.save(tfile, strip_prefix="net_")
    with open(jfile, "rb") as f, open(tfile, "rb") as g:
        assert f.read() == g.read()
    # Each package loads the other's file.
    for loaded in (mx.nd.load(jfile, ctx=mx.cpu()), jmx.nd.load(tfile)):
        assert sorted(loaded) == ["b", "c", "w"]
        for k, v in loaded.items():
            np.testing.assert_array_equal(v.asnumpy(), arrays["net_" + k])
    with mx.cpu():
        fresh = mx.gluon.ParameterDict("net_")
        fresh.get("w", shape=(3, 4))
        fresh.get("b", shape=(4,))
        fresh.get_constant("c", np.zeros((2, 2), np.float32))
        fresh.load(jfile, ctx=mx.cpu(), restore_prefix="net_")
        for k, v in arrays.items():
            np.testing.assert_array_equal(fresh[k].data().asnumpy(), v)
        with pytest.raises(ValueError, match="missing"):
            extra = mx.gluon.ParameterDict("net_")
            extra.get("z", shape=(1,))
            extra.load(jfile, restore_prefix="net_")


def test_reset_ctx_keeps_values_and_grad_buffers():
    with mx.cpu():
        pd = _pdict(mx, {"net_w": X[0, :, :], "net_b": X[0, 0],
                         "net_c": X[1, :2, :2]}, ctx=mx.cpu())
        w = pd["net_w"]
        before = w.data().asnumpy()
        pd.reset_ctx(mx.cpu())
        np.testing.assert_array_equal(w.data().asnumpy(), before)
        assert w.list_ctx() == [mx.cpu()]
        assert w.grad().shape == (3, 4)


def test_split_data_and_split_and_load_equal_jax():
    data = np.arange(30, dtype=np.float32).reshape(10, 3)

    def fn(pkg, arr):
        u = pkg.gluon.utils
        even = [s.asnumpy() for s in u.split_data(arr(data), 5)]
        uneven = [s.asnumpy() for s in u.split_data(arr(data), 3,
                                                    even_split=False)]
        axis1 = [s.asnumpy() for s in u.split_data(arr(data), 3,
                                                   batch_axis=1)]
        ctx = pkg.cpu()
        loaded = u.split_and_load(data, [ctx])
        return even, uneven, axis1, [x.asnumpy() for x in loaded]

    want, got = _both(fn)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    with mx.cpu(), pytest.raises(ValueError):
        mx.gluon.utils.split_data(mx.nd.array(data, ctx=mx.cpu()), 4)
    with mx.cpu():
        (one,) = mx.gluon.utils.split_and_load(
            mx.nd.array(data, ctx=mx.cpu()), [mx.cpu()])
        assert one.context == mx.cpu()


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_global_norm_equals_jax(max_norm):
    rng = np.random.RandomState(6)
    grads = [rng.randn(*s).astype(np.float32) for s in [(3, 4), (5,), (2,
                                                                       2)]]

    def fn(pkg, arr):
        arrays = [arr(g) for g in grads]
        norm = pkg.gluon.utils.clip_global_norm(arrays, max_norm)
        return norm, [a.asnumpy() for a in arrays]

    (wn, wa), (gn, ga) = _both(fn)
    want_norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                              for g in grads))
    assert abs(gn - want_norm) <= 1e-6 * want_norm
    assert abs(gn - wn) <= 1e-6 * wn
    for g, w in zip(ga, wa):
        _close(g, w)
    if max_norm < want_norm:
        total = math.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                              for a in ga))
        assert abs(total - max_norm) <= 1e-5 * max_norm


def test_check_sha1_and_download_from_a_file_url(tmp_path, monkeypatch):
    import hashlib
    import socket

    def no_network(*a, **k):
        raise AssertionError("download opened a network connection")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    src = tmp_path / "src.bin"
    payload = os.urandom(3000)
    src.write_bytes(payload)
    digest = hashlib.sha1(payload).hexdigest()
    u = mx.gluon.utils
    assert u.check_sha1(str(src), digest)
    assert not u.check_sha1(str(src), "0" * 40)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    got = u.download("file://" + str(src), path=str(out_dir),
                     sha1_hash=digest)
    assert got == str(out_dir / "src.bin")
    assert (out_dir / "src.bin").read_bytes() == payload
    # A file in place is kept; any other URL raises without connecting.
    assert u.download("http://example.invalid/src.bin",
                      path=str(out_dir)) == got
    with pytest.raises(RuntimeError, match="network"):
        u.download("http://example.invalid/other.bin", path=str(out_dir))
    with pytest.raises(ValueError, match="SHA-1"):
        u.download("file://" + str(src), path=str(tmp_path / "x.bin"),
                   sha1_hash="0" * 40)
    assert u.check_sha1(jmx.gluon.utils.download(
        "file://" + str(src), path=str(tmp_path / "j.bin")), digest)


# -- initializers -------------------------------------------------------------

def _fill(pkg, init, name, shape):
    arr = np.zeros(shape, np.float32)
    return init(pkg.init.InitDesc(name), arr)


@pytest.mark.parametrize("make,name,shape", [
    (lambda pkg: pkg.init.Constant(0.75), "fc_weight", (3, 4)),
    (lambda pkg: pkg.init.Constant(
        np.arange(4, dtype=np.float32)), "fc_weight", (3, 4)),
    (lambda pkg: pkg.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda pkg: pkg.init.Bilinear(), "up_weight", (3, 1, 5, 5)),
    (lambda pkg: pkg.init.One(), "fc_weight", (2, 3)),
    (lambda pkg: pkg.init.Zero(), "fc_weight", (2, 3)),
    (lambda pkg: pkg.init.Normal(), "bn_gamma", (5,)),
    (lambda pkg: pkg.init.MSRAPrelu(), "fc_bias", (5,)),
])
def test_deterministic_initializers_equal_jax(make, name, shape):
    np.testing.assert_array_equal(_fill(mx, make(mx), name, shape),
                                  _fill(jmx, make(jmx), name, shape))


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.init.Normal(0.3),
    lambda pkg: pkg.init.MSRAPrelu("in", 0.1),
    lambda pkg: pkg.init.Orthogonal(2.0, "normal"),
    lambda pkg: pkg.init.Bilinear(),
    lambda pkg: pkg.init.Constant(1.5),
    lambda pkg: pkg.init.One(),
    lambda pkg: pkg.init.Zero(),
])
def test_initializer_names_and_dumps_equal_jax(make):
    assert make(mx).dumps() == make(jmx).dumps()
    again = mx.init.create(make(mx).dumps())
    assert type(again) is type(make(mx))


def test_normal_initializer_law():
    mx.random.seed(0)
    w = _fill(mx, mx.init.Normal(0.3), "fc_weight", (400, 500))
    assert abs(w.mean()) < 0.003
    assert abs(w.std() - 0.3) < 0.003


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 1.0)])
def test_msra_prelu_variance(factor_type, slope):
    """Variance 2 / ((1 + slope^2) fan): fan the (in + out) / 2, in or
    out receptive-field count."""
    mx.random.seed(1)
    shape = (64, 32, 3, 3)
    w = _fill(mx, mx.init.MSRAPrelu(factor_type, slope), "conv_weight",
              shape)
    fan_in, fan_out = 32 * 9, 64 * 9
    fan = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
           "out": fan_out}[factor_type]
    want = 2.0 / ((1 + slope ** 2) * fan)
    assert abs(w.var() / want - 1) < 0.03
    assert abs(w.mean()) < 3 * math.sqrt(want / w.size) * 3


@pytest.mark.parametrize("shape,rand_type", [((6, 10), "uniform"),
                                             ((4, 3, 2, 2), "normal"),
                                             ((12, 5), "uniform")])
def test_orthogonal_rows_are_orthonormal_times_scale(shape, rand_type):
    mx.random.seed(2)
    scale = 1.7
    w = _fill(mx, mx.init.Orthogonal(scale, rand_type), "fc_weight",
              shape).reshape(shape[0], -1).astype(np.float64)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    _close(gram, scale ** 2 * np.eye(gram.shape[0]), rtol=0, atol=1e-5)


def test_mixed_dispatches_on_the_first_matching_pattern():
    """The first pattern matching the name picks the initializer, which
    then dispatches on the name's suffix (a bias is zero), in both
    packages."""
    for pkg in (mx, jmx):
        mixed = pkg.init.Mixed(["fc1_.*", ".*"],
                               [pkg.init.Constant(2.0), pkg.init.One()])
        assert np.all(_fill(pkg, mixed, "fc1_weight", (3,)) == 2.0)
        assert np.all(_fill(pkg, mixed, "fc2_weight", (2, 2)) == 1.0)
        assert np.all(_fill(pkg, mixed, "fc1_bias", (2,)) == 0.0)
        with pytest.raises(ValueError):
            _fill(pkg, pkg.init.Mixed(["conv.*"], [pkg.init.One()]),
                  "fc_weight", (2,))
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=2)
        net.initialize(init=mx.init.Mixed([".*weight", ".*"],
                                          [mx.init.Constant(0.5),
                                           mx.init.One()]), ctx=mx.cpu())
        assert np.all(net.weight.data().asnumpy() == 0.5)
        assert np.all(net.bias.data().asnumpy() == 0.0)


# -- symbol rules -------------------------------------------------------------

@pytest.mark.parametrize("op,shape,attrs", [
    ("LayerNorm", (4, 5, 6), {}),
    ("LayerNorm", (4, 5, 6), {"axis": 1}),
    ("InstanceNorm", (2, 3, 7, 7), {}),
    ("Deconvolution", (2, 4, 5, 5), {"kernel": (4, 4), "stride": (2, 2),
                                     "pad": (1, 1), "num_filter": 6,
                                     "num_group": 2}),
    ("Deconvolution", (2, 4, 5, 5), {"kernel": (3, 3), "num_filter": 3,
                                     "no_bias": True}),
    ("LinearRegressionOutput", (8, 3), {}),
    ("LogisticRegressionOutput", (8, 3), {}),
    ("MAERegressionOutput", (8, 3), {}),
])
def test_infer_shape_equals_jax(op, shape, attrs):
    def build(sym):
        return getattr(sym, op)(sym.var("data"), name="n", **attrs)

    j, t = build(jmx.sym), build(mx.sym)
    assert t.list_arguments() == j.list_arguments()
    assert t.infer_shape(data=shape) == j.infer_shape(data=shape)


def test_regression_output_binds_and_trains_its_label():
    data = mx.sym.var("data")
    out = mx.sym.LinearRegressionOutput(data, name="lro", grad_scale=2.0)
    x = np.float32([[1.0, 2.0], [0.5, -1.0]])
    y = np.float32([[0.0, 1.0], [1.0, 1.0]])
    with mx.cpu():
        ex = out.bind(mx.cpu(), {"data": mx.nd.array(x, ctx=mx.cpu()),
                                 "lro_label": mx.nd.array(y, ctx=mx.cpu())},
                      args_grad={"data": mx.nd.zeros((2, 2), ctx=mx.cpu())})
        ex.forward(is_train=True)
        ex.backward()
        _close(ex.grad_dict["data"].asnumpy(), 2.0 * (x - y))


def test_creation_ops_in_a_symbol_graph():
    s = mx.sym.arange(0, 6, 1.5) + mx.sym.ones((4,))
    with mx.cpu():
        assert s.infer_shape()[1] == [(4,)]
        ex = s.bind(mx.cpu(), {})
        ex.forward()
        np.testing.assert_array_equal(ex.outputs[0].asnumpy(),
                                      [1.0, 2.5, 4.0, 5.5])
    assert mx.sym.zeros((2, 3)).infer_shape()[1] == [(2, 3)]


# -- the reference's roundings and make_loss ----------------------------------

# 0.49999997 is the float32 below 0.5, where floor(|x| + 0.5) rounds
# wrong; 4194304.5 = 2^22 + 0.5, a half at the precision's edge.
HALVES = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -0.49999997,
                   2.4, -2.6, 4194304.5, 0.0], np.float32)
ROUND = np.array([-3, -2, -1, 1, 2, 3, 0, 0, 2, -3, 4194305, 0], np.float32)
RINT = np.array([-3, -2, -1, 0, 1, 2, 0, 0, 2, -3, 4194304, 0], np.float32)


def _roundings(ctx):
    x = mx.nd.array(HALVES, ctx=ctx)
    return (mx.nd.round(x).asnumpy(), mx.nd.rint(x).asnumpy(),
            mx.nd.fix(x).asnumpy(), x.round().asnumpy())


def test_round_halves_away_from_zero_and_rint_halves_down():
    """The reference's mshadow_op.h: round is C's round(), rint takes
    floor on a tie (the JAX package rounds both to even)."""
    with mx.cpu():
        r, ri, fix, method = _roundings(mx.cpu())
    np.testing.assert_array_equal(r, ROUND)
    np.testing.assert_array_equal(method, ROUND)
    np.testing.assert_array_equal(ri, RINT)
    np.testing.assert_array_equal(fix, np.trunc(HALVES))


@pytest.mark.parametrize("normalization,want", [
    ("null", 0.5), ("batch", 0.5 / 4), ("valid", 0.5 / 5)])
def test_make_loss_gradient_is_the_references(normalization, want):
    """grad_scale per element, over the batch size or the count of
    outputs above valid_thresh, whatever the head gradient."""
    x = np.float32([[0.1, 0.9, 0.3], [0.8, 0.2, 0.7],
                    [0.6, 0.05, 0.95], [0.0, 0.4, 0.5]])  # 5 above 0.55
    with mx.cpu():
        a = mx.nd.array(x, ctx=mx.cpu())
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.MakeLoss(a, grad_scale=0.5, valid_thresh=0.55,
                               normalization=normalization)
        y.backward(mx.nd.array(np.full(x.shape, 7.0, np.float32),
                               ctx=mx.cpu()))
        np.testing.assert_array_equal(y.asnumpy(), x)
        _close(a.grad.asnumpy(), np.full(x.shape, want, np.float32))


# -- the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_roundings_on_the_card():
    _card()
    r, ri, fix, method = _roundings(mx.gpu(0))
    np.testing.assert_array_equal(r, ROUND)
    np.testing.assert_array_equal(ri, RINT)
    np.testing.assert_array_equal(fix, np.trunc(HALVES))


@pytest.mark.cuda
def test_empty_cache_returns_the_cards_cached_memory():
    _card()
    x = mx.nd.zeros((1024, 1024, 64), ctx=mx.gpu(0))
    del x
    before = torch.cuda.memory_reserved(0)
    mx.gpu(0).empty_cache()
    assert torch.cuda.memory_reserved(0) < before


def test_empty_cache_on_the_host_is_a_no_op():
    mx.cpu().empty_cache()
