"""The contrib tail of ``ops/contrib_ops.py`` (12 names: adaptive average
pooling, bilinear resize, FFT, IFFT, index copy and count sketch, each
with its alias) in the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through each package's
imperative dispatch: forward outputs, and the gradients of the float
inputs for a random head gradient. Tolerances (fp32): rtol 1e-5, atol
1e-5, except where a case states otherwise; ``F.interpolate`` computes
its align-corners source coordinates in another order than the JAX op's
``arange * ratio``, and ``F.adaptive_avg_pool2d`` sums a bin and divides
where the JAX op multiplies by 1/n through a matrix: each is a rounding
apart. ``index_copy``'s indices are distinct (with a repeated index the
row that lands depends on the order of the writes in both packages).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

from torch_op_parity import assert_close, both

torch.set_num_threads(2)

TOL = (1e-5, 1e-5)


def _x(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1) \
        .astype(np.float32)


def _count_sketch_inputs():
    rng = np.random.RandomState(7)
    h = rng.randint(0, 5, (1, 10)).astype(np.float32)
    h[0, :3] = 2                         # repeated buckets
    s = (rng.randint(0, 2, (1, 10)) * 2 - 1).astype(np.float32)
    return [_x(8, 3, 10), h, s]


# op -> [(tag, inputs, attrs, wrt)]
CASES = {
    "AdaptiveAvgPooling2D": [
        ("out3", lambda: [_x(1, 2, 3, 7, 9)], {"output_size": 3}, (0,)),
        ("out4x2", lambda: [_x(2, 2, 3, 7, 9)], {"output_size": (4, 2)},
         (0,)),
        ("global", lambda: [_x(3, 2, 4, 5, 5)], {}, (0,))],
    "BilinearResize2D": [
        ("up_down", lambda: [_x(4, 2, 3, 5, 6)], {"height": 9, "width": 4},
         (0,)),
        # 5 x 1.5 = 7.5 rounds half to even: 8.
        ("scale", lambda: [_x(5, 2, 3, 5, 6)],
         {"scale_height": 1.5, "scale_width": 0.5}, (0,)),
        ("to_one_row", lambda: [_x(6, 1, 2, 4, 4)], {"height": 1,
                                                    "width": 7}, (0,)),
        ("unchanged", lambda: [_x(7, 1, 2, 4, 4)], {"height": 4,
                                                   "width": 4}, (0,))],
    "fft": [("", lambda: [_x(9, 2, 3, 16)], {}, (0,))],
    "ifft": [("", lambda: [_x(10, 2, 32)], {"compute_size": 4}, (0,))],
    "index_copy": [
        ("", lambda: [_x(11, 6, 4), np.array([4, 0, 2], np.float32),
                      _x(12, 3, 4)], {}, (0, 2))],
    "count_sketch": [("", _count_sketch_inputs, {"out_dim": 5}, (0, 2))],
}

ALIASES = {"AdaptiveAvgPooling2D": "adaptive_avg_pooling2d",
           "BilinearResize2D": "bilinear_resize2d", "fft": "FFT",
           "ifft": "IFFT", "index_copy": "IndexCopy",
           "count_sketch": "CountSketch"}

NAMES = [("_contrib_" + n, op, i) for op in sorted(CASES)
         for n in (op, ALIASES[op]) for i in range(len(CASES[op]))]


def _id(case):
    name, op, i = case
    tag = CASES[op][i][0]
    return name + ("-" + tag if tag else "")


@pytest.mark.parametrize("case", NAMES, ids=[_id(c) for c in NAMES])
def test_contrib_op_equals_jax(case):
    name, op, i = case
    _, make, attrs, wrt = CASES[op][i]
    (want, want_g), (got, got_g) = both(name, make(), attrs, wrt)
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype == np.float32
    assert_close(got, want, *TOL, what=name)
    assert_close(got_g, want_g, *TOL, what=name + " grad")


def test_ifft_of_fft_is_d_times_the_input():
    x = _x(20, 3, 8)
    with mx.cpu():
        c = mx.nd.contrib.fft(mx.nd.array(x, ctx=mx.cpu()))
        back = mx.nd.contrib.ifft(c)
    assert c.shape == (3, 16)
    np.testing.assert_allclose(back.asnumpy(), 8 * x, atol=1e-5)
    want = np.fft.fft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(c.asnumpy()[:, 0::2], want.real, atol=1e-5)
    np.testing.assert_allclose(c.asnumpy()[:, 1::2], want.imag, atol=1e-5)


def test_float64_stays_float64_and_half_computes_in_float32():
    """The port computes in float64 for float64 inputs (the JAX package,
    x64 off, has none) and in float32 for the rest; adaptive pooling and
    resize cast back to the input's dtype, as the JAX ops do."""
    x = _x(21, 1, 2, 6, 6)
    with mx.cpu():
        for dt in ("float64", "float16"):
            a = mx.nd.array(x, ctx=mx.cpu(), dtype=dt)
            pooled = mx.nd.contrib.AdaptiveAvgPooling2D(a, output_size=2)
            resized = mx.nd.contrib.BilinearResize2D(a, height=3, width=9)
            f = mx.nd.contrib.fft(a.reshape((2, 36)))
            assert pooled.dtype == resized.dtype == np.dtype(dt)
            assert f.dtype == np.dtype(dt if dt == "float64"
                                       else "float32")
    want = x.astype(np.float64).reshape(1, 2, 2, 3, 2, 3).mean(axis=(3, 5))
    with mx.cpu():
        got = mx.nd.contrib.AdaptiveAvgPooling2D(
            mx.nd.array(x, ctx=mx.cpu(), dtype="float64"), output_size=2)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-12)


def test_chip_smoke_tail_sweep_rehearses_on_the_host(monkeypatch):
    """``chip_smoke.py`` phase 17's sweep of the registry's tail runs every
    one of the 39 names, held to its family's limit (and gelqf/syevd to
    their sign-free invariants), here at small widths with the host's
    fp32 in the card's place."""
    import chip_smoke
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    rest = {n for n, op in jreg.OP_REGISTRY.items()
            if op.fn.__module__.rsplit(".", 1)[-1] in ("sequence",
                                                        "contrib_ops")
            and not n.lower().startswith("sequence")
            and "ctc" not in n.lower()}
    assert set(chip_smoke.TAIL_SURFACE_NAMES) == rest and len(rest) == 39
    assert rest <= set(treg.OP_REGISTRY)
    monkeypatch.setattr(chip_smoke, "TAIL", {
        "spd": (4, 12, 12), "lq": (4, 6, 10), "det": (4, 5, 5),
        "kr": ((3, 6), (4, 6)), "rhs": 3, "pool": 3, "resize": 9,
        "fft": (4, 16), "embed": (20, 5), "copy_rows": 6,
        "sketch": (4, 16, 8)})
    monkeypatch.setitem(chip_smoke.SURFACE, "act", (4, 3, 8, 8))
    monkeypatch.setitem(chip_smoke.SURFACE, "image", (4, 3, 6, 6))
    monkeypatch.setattr(chip_smoke, "log", lambda *a: None)
    # One thread: the CPU torch these tests run under (2.13, oneMKL) has
    # hung in LAPACK's getrf (``DLASWP`` "Parameter 6 was incorrect") on
    # a batch of square matrices with more than one thread.
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            ran, families = chip_smoke._core_sweep(
                mx, "cpu", mx.cpu(), chip_smoke._tail_cases(),
                sweep="tail", queued=False)
    finally:
        torch.set_num_threads(2)
    assert ran == rest
    assert set(families) == {"linalg", "reduce", "resampling", "matrix"}
    assert all(f["worst_share_of_limit"] <= 1.0 for f in families.values())
