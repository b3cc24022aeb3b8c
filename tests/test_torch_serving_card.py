"""The serving slice on the card (``cuda``-marked; they skip on a host
without one). No JAX here: the references are the port's plain versions
on the host.

- ``torch._int_mm`` carries the int8 contraction on the card and equals
  the float64 product of the integer values, at shapes on and off its
  shape rules (the operands are zero-padded onto them);
- ``_contrib_quantized_conv`` on the card equals the host's bit for bit,
  one int8 GEMM per group;
- a ``ModelGateway`` on gpu(0) serves an MLP in fp32, int8 and bf16,
  each within float32 (bfloat16) tolerance of the same backend on the
  host, one signature per bucket.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.ops import quantization_ops as qo

from torch_gateway_mesh_prog import MESH_PARAMS, mlp, mlp_params

torch.set_num_threads(2)

C = mx.cpu()


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 16, 8), (32, 4608, 512),
                                   (100, 147, 64), (1, 3, 1)])
def test_int_mm_on_the_card_equals_the_float64_product(m, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = _rng(6)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    before = qo.INT8_GEMMS
    got = qo.int8_matmul_nt(torch.from_numpy(a).cuda(),
                            torch.from_numpy(b).cuda())
    assert qo.INT8_GEMMS == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = a.astype(np.float64) @ b.astype(np.float64).T
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_quantized_conv_on_the_card_equals_the_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = _rng(7)
    d = rng.standard_normal((4, 8, 14, 14), np.float32)
    w = rng.integers(-127, 128, (16, 4, 3, 3)).astype(np.int8)
    attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_group=2,
                 num_filter=16, min_data=-2.0, max_data=2.0, w_scale=5.0,
                 no_bias=True)
    before = qo.INT8_GEMMS
    card = mx.nd._contrib_quantized_conv(
        mx.nd.array(d, ctx=mx.gpu(0)),
        mx.nd.array(w, ctx=mx.gpu(0), dtype="int8"), **attrs).asnumpy()
    assert qo.INT8_GEMMS == before + 2          # one GEMM per group
    host = mx.nd._contrib_quantized_conv(
        mx.nd.array(d, ctx=C), mx.nd.array(w, ctx=C, dtype="int8"),
        **attrs).asnumpy()
    np.testing.assert_array_equal(card, host)


@pytest.mark.cuda
def test_gateway_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = torch.backends
    old = b.cuda.matmul.allow_tf32
    b.cuda.matmul.allow_tf32 = False
    ps = mlp_params()
    g = mx.gpu(0)
    gw = serving.ModelGateway(ctx=g)
    try:
        for mode in (None, "int8", "bf16"):
            gw.register(serving.ModelSpec(
                str(mode), fn=mlp(mx), params=[mx.nd.array(p, ctx=g)
                                               for p in ps],
                item_shape=(MESH_PARAMS["in"],), max_batch=8, quantize=mode))
        x = np.random.default_rng(5).standard_normal(
            (3, MESH_PARAMS["in"]), np.float32)
        for mode in (None, "int8", "bf16"):
            res = gw.predict(str(mode), x)
            assert res.output.context == g
            host = serving.registry.QuantizedFnModel(
                mlp(mx), ps, mode, ctx=C) if mode else \
                serving.registry._FnModel(mlp(mx), ps, ctx=C)
            pad = np.zeros((1, x.shape[1]), np.float32)
            want = host(mx.nd.array(np.vstack([x, pad]), ctx=C)).asnumpy()
            tol = 2 ** -6 if mode == "bf16" else 1e-5
            np.testing.assert_allclose(res.output.asnumpy(), want[:3],
                                       rtol=tol,
                                       atol=tol * np.abs(want).max())
            assert gw._state(str(mode)).backend.compile_count == 4
    finally:
        gw.shutdown()
        b.cuda.matmul.allow_tf32 = old
