"""The six quantization ops of the port (``ops/quantization_ops.py``)
against the JAX package's, on the same numpy inputs.

- ``_contrib_quantize``, ``_contrib_quantize_v2``, ``_contrib_dequantize``
  and ``_contrib_requantize``: the same int8 (or float32) values and the
  same ranges, bit for bit;
- ``_contrib_quantized_fully_connected`` and ``_contrib_quantized_conv``:
  the int32 accumulator equals a float64 product of the integer values
  exactly (checked through the float32 epilogue, which is exact given
  the accumulator), and without a bias the output is the JAX package's
  bit for bit. With a bias, XLA on the host contracts the epilogue's
  product and the bias add into one FMA while the port rounds twice, so
  there the two agree within one float32 rounding of the output;
- the symbol shape rules of the two contractions are the JAX package's.
The card tests are in tests/test_torch_serving_card.py.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import quantization_ops as qo

torch.set_num_threads(2)

C = mx.cpu()
NAMES = ("_contrib_quantize", "_contrib_quantize_v2", "_contrib_dequantize",
         "_contrib_requantize", "_contrib_quantized_fully_connected",
         "_contrib_quantized_conv")


def _both(name, arrays, **attrs):
    """(port outputs, JAX outputs) as lists of numpy arrays."""
    got = getattr(mx.nd, name)(
        *[mx.nd.array(a, ctx=C, dtype=a.dtype) for a in arrays], **attrs)
    want = getattr(jmx.nd, name)(
        *[jmx.nd.array(a, dtype=a.dtype) for a in arrays], **attrs)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    return ([g.asnumpy() for g in got],
            [np.asarray(w.asnumpy()) for w in want])


def _rng(seed=0):
    return np.random.default_rng(seed)


def _range(lo, hi):
    return np.array([lo], np.float32), np.array([hi], np.float32)


ELEMENTWISE = {
    "quantize": ("_contrib_quantize",
                 lambda r: (r.standard_normal((4, 8, 6, 6), np.float32) * 3,
                            *_range(-2.5, 3.1)), {}),
    "quantize_wide_range": ("_contrib_quantize",
                            lambda r: (r.standard_normal((64,), np.float32),
                                       *_range(-40.0, 7.0)), {}),
    "quantize_v2_data_range": ("_contrib_quantize_v2",
                               lambda r: (r.standard_normal((5, 33),
                                                            np.float32),),
                               {}),
    "quantize_v2_calibrated": ("_contrib_quantize_v2",
                               lambda r: (r.standard_normal((5, 33),
                                                            np.float32),),
                               {"min_calib_range": -1.5,
                                "max_calib_range": 2.0}),
    "dequantize": ("_contrib_dequantize",
                   lambda r: (r.integers(-127, 128, (5, 7)).astype(np.int8),
                              *_range(-2.5, 3.1)), {}),
    "requantize_data_range": ("_contrib_requantize",
                              lambda r: (r.integers(-2 ** 20, 2 ** 20, (5, 7))
                                         .astype(np.int32),
                                         *_range(-2.5, 3.1)), {}),
    "requantize_calibrated": ("_contrib_requantize",
                              lambda r: (r.integers(-2 ** 20, 2 ** 20, (5, 7))
                                         .astype(np.int32),
                                         *_range(-2.5, 3.1)),
                              {"min_calib_range": -0.3,
                               "max_calib_range": 0.2}),
}


@pytest.mark.parametrize("case", sorted(ELEMENTWISE))
def test_elementwise_ops_equal_the_jax_package_bit_for_bit(case):
    name, make, attrs = ELEMENTWISE[case]
    got, want = _both(name, make(_rng()), **attrs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _host_int8(data, lo, hi):
    """The activation's int8 values (numpy: the port's rounding)."""
    scale = np.float32(qo._scale_of(lo, hi))
    return np.clip(np.round(data * scale), -127, 127)


def _epilogue(acc64, a_scale, w_scale):
    """float32(acc) times the float32 reciprocal of the combined scale."""
    recip = np.float32(1.0) / np.float32(a_scale * w_scale)
    return acc64.astype(np.float32) * recip


def _fc_case(rng, rows=5, depth=16, units=8):
    return (rng.standard_normal((rows, depth), np.float32),
            rng.integers(-127, 128, (units, depth)).astype(np.int8),
            rng.standard_normal(units, np.float32))


def test_quantized_fc_is_an_exact_integer_contraction():
    d, w, _ = _fc_case(_rng(1))
    attrs = dict(num_hidden=8, min_data=-2.0, max_data=2.5, w_scale=3.3,
                 no_bias=True)
    got, want = _both("_contrib_quantized_fully_connected", (d, w), **attrs)
    acc = _host_int8(d, -2.0, 2.5).astype(np.float64) @ \
        w.astype(np.float64).T
    np.testing.assert_array_equal(
        got[0], _epilogue(acc, qo._scale_of(-2.0, 2.5), 3.3))
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("flatten", [True, False])
def test_quantized_fc_with_bias_within_one_rounding(flatten):
    rng = _rng(2)
    # flatten=False on data of more than 2 dims contracts the last dim in
    # the reference (and the port); the JAX package's contraction takes
    # dim 1, so the case stays 2-D.
    d = rng.standard_normal((3, 2, 8) if flatten else (3, 8), np.float32)
    w = rng.integers(-127, 128, (6, 16 if flatten else 8)).astype(np.int8)
    b = rng.standard_normal(6, np.float32)
    attrs = dict(num_hidden=6, min_data=-1.5, max_data=1.5, flatten=flatten)
    got, want = _both("_contrib_quantized_fully_connected", (d, w, b),
                      **attrs)
    assert got[0].shape == want[0].shape
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(got[0], want[0], rtol=eps,
                               atol=eps * np.abs(want[0]).max())


CONVS = {
    "2d_groups_stride_pad": ((2, 8, 7, 7), (6, 4, 3, 3),
                             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  num_group=2, num_filter=6)),
    "2d_dilate": ((2, 3, 9, 9), (4, 3, 3, 3),
                  dict(kernel=(3, 3), dilate=(2, 2), num_filter=4)),
    "1d": ((2, 4, 11), (5, 4, 3), dict(kernel=(3,), pad=(1,),
                                        num_filter=5)),
    "1x1_default_attrs": ((3, 16, 4, 4), (8, 16, 1, 1),
                          dict(num_filter=8)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quantized_conv_is_an_exact_integer_contraction(case):
    dshape, wshape, attrs = CONVS[case]
    rng = _rng(3)
    d = rng.standard_normal(dshape, np.float32) * 2
    w = rng.integers(-127, 128, wshape).astype(np.int8)
    attrs = dict(attrs, min_data=-2.0, max_data=2.5, w_scale=3.0,
                 no_bias=True)
    got, want = _both("_contrib_quantized_conv", (d, w), **attrs)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    # The accumulator, from a float64 convolution of the integer values.
    q = torch.from_numpy(_host_int8(d, -2.0, 2.5).astype(np.float64))
    conv = {1: torch.nn.functional.conv1d,
            2: torch.nn.functional.conv2d}[len(wshape) - 2]
    acc = conv(q, torch.from_numpy(w.astype(np.float64)),
               stride=attrs.get("stride", 1), padding=attrs.get("pad", 0),
               dilation=attrs.get("dilate", 1),
               groups=attrs.get("num_group", 1)).numpy()
    np.testing.assert_array_equal(
        got[0], _epilogue(acc, qo._scale_of(-2.0, 2.5), 3.0))


def test_quantized_conv_bias_within_one_rounding():
    rng = _rng(4)
    d = rng.standard_normal((2, 4, 6, 6), np.float32)
    w = rng.integers(-127, 128, (5, 4, 3, 3)).astype(np.int8)
    b = rng.standard_normal(5, np.float32)
    got, want = _both("_contrib_quantized_conv", (d, w, b), kernel=(3, 3),
                      num_filter=5, min_data=-2.0, max_data=2.0)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(got[0], want[0], rtol=eps,
                               atol=eps * np.abs(want[0]).max())


def test_int8_matmul_takes_int8_only_and_is_exact_on_the_host():
    rng = _rng(5)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 2000)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (5, 2000)).astype(np.int8))
    got = qo.int8_matmul_nt(a, b)
    assert got.dtype == torch.int32
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="int8"):
        qo.int8_matmul_nt(a.float(), b)


def test_the_six_names_are_registered_and_int8_is_a_feature():
    from mxnet_tpu_torch.ops import registry

    assert set(NAMES) <= set(registry.list_all_ops())
    assert mx.libinfo.features()["INT8"] is True


@pytest.mark.parametrize("op,kw,data_shape", [
    ("_contrib_quantized_conv", dict(kernel=(3, 3), num_filter=4,
                                     pad=(1, 1)), (2, 3, 8, 8)),
    ("_contrib_quantized_fully_connected", dict(num_hidden=5), (2, 3, 4)),
])
def test_quantized_symbol_shapes_follow_the_jax_package(op, kw, data_shape):
    def build(pkg):
        return getattr(pkg.sym, op)(pkg.sym.var("data"),
                                    pkg.sym.var("q_weight"),
                                    pkg.sym.var("q_bias"), name="q", **kw)

    got, want = build(mx), build(jmx)
    assert got.list_arguments() == want.list_arguments()
    assert got.infer_shape(data=data_shape) == \
        want.infer_shape(data=data_shape)
