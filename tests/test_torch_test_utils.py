"""``mx.test_utils`` of the port against the JAX package's.

- ``rand_ndarray`` under one ``np.random.seed``: the same values in both
  packages, dense, ``row_sparse`` and ``csr`` (exact: both draw with
  numpy and convert on the host or device without arithmetic);
- ``assert_almost_equal``: the same message on the same failing inputs,
  and ``almost_equal``/``same`` the same answers;
- ``check_numeric_gradient`` and ``check_consistency`` (``ctx_list=
  [cpu(0), cpu(0)]``) pass on the same functions in both packages and
  fail on the same planted wrong gradient (``x * BlockGrad(x)``, whose
  autograd gradient is x where the true one is 2x), at the JAX
  package's defaults (rtol 1e-2, atol 1e-3);
- ``nd.contrib.flash_attention`` on the host goes through its plain
  version: no kernel launch is counted, its output is the plain
  reference's bit for bit and within fp32's ``kernel_tolerance`` of
  the JAX package's op;
- ``check_speed`` returns a positive time; ``count_dispatches`` counts
  the port's dispatches of a known sequence of ops.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as ttu

torch.set_num_threads(2)

C = mx.cpu()


def test_every_name_of_the_jax_packages_all_is_here():
    assert ttu.__all__ == jtu.__all__
    for name in jtu.__all__:
        assert callable(getattr(ttu, name)), name
    assert mx.test_utils is ttu


def test_default_context_follows_the_current_one():
    assert ttu.default_context() == mx.gpu(0)
    with C:
        assert ttu.default_context() == C
    ttu.set_default_context(C)
    try:
        assert ttu.default_context() == C
        assert ttu.rand_ndarray((2, 2)).context == C
    finally:
        ttu.set_default_context(None)
    assert ttu.default_context() == mx.gpu(0)


@pytest.mark.parametrize("stype,density", [
    ("default", None), ("row_sparse", 0.3), ("csr", 0.5),
    ("row_sparse", None)])
def test_rand_ndarray_equals_the_jax_packages(stype, density):
    shape = (6, 5)
    np.random.seed(17)
    got = ttu.rand_ndarray(shape, stype=stype, density=density, ctx=C)
    after_port = np.random.rand()
    np.random.seed(17)
    want = jtu.rand_ndarray(shape, stype=stype, density=density)
    after_jax = np.random.rand()
    assert after_port == after_jax      # the same numbers were drawn
    assert got.stype == want.stype == stype
    assert got.context == C
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.random.seed(3)
    shapes = (ttu.rand_shape_2d(), ttu.rand_shape_3d(), ttu.rand_shape_nd(4))
    np.random.seed(3)
    assert shapes == (jtu.rand_shape_2d(), jtu.rand_shape_3d(),
                      jtu.rand_shape_nd(4))


@pytest.mark.parametrize("a,b,kw", [
    (np.float32([1.0, 2.0, 3.0]), np.float32([1.0, 2.5, 3.0]), {}),
    (np.float32([[1e-3, 2.0], [4.0, -1.0]]),
     np.float32([[1e-3, 2.0], [4.0, -1.1]]), {}),
    (np.float16([0.5, 4.0]), np.float16([0.5, 4.25]), {"rtol": 1e-3}),
    (np.float32(2.0), np.float32(3.0), {"atol": 0.5, "names": ("x", "y")}),
])
def test_assert_almost_equal_raises_the_same_message(a, b, kw):
    with pytest.raises(AssertionError) as tmsg:
        ttu.assert_almost_equal(mx.nd.array(a, ctx=C, dtype=a.dtype), b,
                                **kw)
    with pytest.raises(AssertionError) as jmsg:
        jtu.assert_almost_equal(jmx.nd.array(a, dtype=a.dtype), b, **kw)
    assert str(tmsg.value) == str(jmsg.value)
    assert ttu.almost_equal(a, b) == jtu.almost_equal(a, b)
    ttu.assert_almost_equal(mx.nd.array(a, ctx=C, dtype=a.dtype), a)
    assert ttu.same(mx.nd.array(a, ctx=C, dtype=a.dtype), a)
    assert ttu.same(a, b) == jtu.same(a, b) is False


def _fc(m):
    return lambda a, c, d: m.nd.FullyConnected(a, c, d, num_hidden=2)


def _softmax_weighted(m, wgt):
    return lambda a: m.nd.softmax(a) * m.nd.array(wgt, ctx=a.context)


def _planted(m):
    """Autograd differentiates x * BlockGrad(x) to x; the truth is 2x."""
    return lambda a: a * m.nd.BlockGrad(a)


def _cases():
    rng = np.random.RandomState(5)
    x = rng.rand(3, 5).astype(np.float32)
    w = rng.rand(2, 5).astype(np.float32)
    b = rng.rand(2).astype(np.float32)
    wgt = rng.rand(3, 5).astype(np.float32)
    return {"fc": (_fc, [x, w, b], {}),
            "softmax": (lambda m: _softmax_weighted(m, wgt), [x],
                        {"rtol": 2e-2, "atol": 5e-3}),
            "tanh": (lambda m: (lambda a: m.nd.tanh(a)), [x + 0.5], {})}


@pytest.mark.parametrize("case", ["fc", "softmax", "tanh"])
def test_check_numeric_gradient_passes_in_both(case):
    make, inputs, kw = _cases()[case]
    with C:
        ttu.check_numeric_gradient(make(mx), inputs, **kw)
    ttu.check_numeric_gradient(make(mx), inputs, ctx=C, **kw)
    jtu.check_numeric_gradient(make(jmx), inputs, **kw)


def test_check_numeric_gradient_fails_on_a_planted_wrong_gradient():
    x = np.random.RandomState(2).rand(2, 3).astype(np.float32) + 0.5
    with pytest.raises(AssertionError, match=r"autograd\[0\] and "
                       r"numeric\[0\] differ") as tmsg:
        ttu.check_numeric_gradient(_planted(mx), [x], ctx=C)
    with pytest.raises(AssertionError) as jmsg:
        jtu.check_numeric_gradient(_planted(jmx), [x])
    assert str(tmsg.value).split(" at ")[0] == \
        str(jmsg.value).split(" at ")[0]


@pytest.mark.parametrize("case", ["fc", "softmax", "tanh"])
def test_check_consistency_on_two_host_contexts(case):
    make, inputs, _ = _cases()[case]
    touts = ttu.check_consistency(make(mx), inputs, ctx_list=[C, mx.cpu(0)])
    jouts = jtu.check_consistency(make(jmx), inputs,
                                  ctx_list=[jmx.cpu(0), jmx.cpu(0)])
    assert len(touts) == len(jouts) == 2
    ttu.assert_almost_equal(touts[0], jouts[0], rtol=1e-5, atol=1e-6)


def test_check_consistency_fails_where_contexts_differ():
    """A function that reads its context answers differently on each:
    the oracle catches it in both packages."""
    def on_ctx(m, ctx_a):
        return lambda a: a * (2.0 if a.context == ctx_a else 3.0)

    x = np.ones((2, 2), np.float32)
    with pytest.raises(AssertionError, match="differ"):
        ttu.check_consistency(on_ctx(mx, mx.cpu(0)), [x],
                              ctx_list=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(AssertionError, match="differ"):
        jtu.check_consistency(on_ctx(jmx, jmx.cpu(0)), [x],
                              ctx_list=[jmx.cpu(0), jmx.cpu(1)])


def test_flash_attention_on_the_host_takes_its_plain_version():
    from mxnet_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(7)
    q, k, v = (rng.uniform(-1, 1, (1, 2, 32, 16)).astype(np.float32)
               for _ in range(3))
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    outs = ttu.check_consistency(
        lambda a, b, c: mx.nd.contrib.flash_attention(a, b, c), [q, k, v],
        ctx_list=[C, C])
    want = fa.flash_attention_reference(*(torch.from_numpy(t)
                                          for t in (q, k, v)))[0]
    np.testing.assert_array_equal(outs[0], want.numpy())
    jout = jmx.nd.contrib.flash_attention(
        jmx.nd.array(q), jmx.nd.array(k), jmx.nd.array(v)).asnumpy()
    rtol, atol = fa.kernel_tolerance(torch.float32, want)
    ttu.assert_almost_equal(outs[0], jout, rtol=rtol, atol=atol)
    # Its gradient through the oracle: the plain backward on the host.
    small = [t[:, :1, :8, :8].copy() for t in (q, k, v)]
    ttu.check_numeric_gradient(
        lambda a, b, c: mx.nd.contrib.flash_attention(a, b, c), small,
        ctx=C)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before


def test_check_speed_returns_a_positive_time():
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc")
    whole = ttu.check_speed(net, ctx=C, N=3, data=(4, 4))
    fwd = ttu.check_speed(net, ctx=C, N=3, typ="forward", data=(4, 4))
    assert whole > 0 and fwd > 0
    loc = {"data": np.ones((4, 4)), "fc_weight": np.ones((8, 4)),
           "fc_bias": np.zeros(8)}
    assert ttu.check_speed(net, location=loc, ctx=C, N=2) > 0
    q, k, v = (mx.sym.var(n) for n in "qkv")
    attn = mx.sym.contrib.flash_attention(q, k, v)
    shape = (1, 2, 16, 8)
    assert ttu.check_speed(attn, ctx=C, N=2, q=shape, k=shape, v=shape) > 0
    with pytest.raises(ValueError, match="typ"):
        ttu.check_speed(net, ctx=C, N=1, typ="bogus", data=(4, 4))


def test_count_dispatches_counts_a_known_sequence():
    with C:
        a = mx.nd.ones((3, 3))
        b = mx.nd.ones((3, 3))
        with ttu.count_dispatches() as c:
            d = mx.nd.relu(a + b)
            e = mx.nd.dot(d, b)
            e.sum().asnumpy()
    assert c.count == 4   # add, relu, dot, sum
    with ttu.count_dispatches() as none:
        pass
    assert none.count == 0


@pytest.mark.parametrize("n", [1, 3])
def test_retry_reruns_an_assertion(n):
    calls = []

    @ttu.retry(n)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise AssertionError("flaky %d" % len(calls))
        return "ok"

    if n >= 3:
        assert flaky() == "ok"
    else:
        with pytest.raises(AssertionError, match="flaky 1"):
            flaky()
