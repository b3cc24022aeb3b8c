"""``mx.test_utils``' oracles on the card (``cuda``-marked; each test
skips itself without a CUDA device). They import only the port: the
machine with the card has no JAX.

- ``check_consistency`` of ``nd.contrib.flash_attention`` between the host
  and gpu(0) in fp32 (TF32 off) within ``kernel_tolerance``, launching K1
  once; ``check_numeric_gradient`` of its sum on gpu(0) at the JAX
  package's tolerances (rtol 1e-2, atol 1e-3) with steps of 1e-2: K2 and
  K3 once, K1 once and twice per input element;
- ``check_speed`` of the causal symbol bound on gpu(0): ``whole`` launches
  K1, K2 and K3 once a call and takes longer than ``forward``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import test_utils as ttu


def _card_fp32():
    """TF32 off for the fp32 kernels' comparison; returns the restore."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return restore


@pytest.mark.cuda
def test_oracles_on_the_card_launch_the_flash_attention_kernels():
    """check_consistency (host against card, ``kernel_tolerance``) and
    check_numeric_gradient (finite differences of K1 against K2/K3 at the
    JAX package's defaults) over ``nd.contrib.flash_attention`` in fp32
    on gpu(0), each launching its kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.ops import flash_attention as fa

    restore = _card_fp32()
    try:
        rng = np.random.RandomState(3)
        qkv = [rng.uniform(-1, 1, (1, 4, 256, 64)).astype(np.float32)
               for _ in range(3)]
        want = fa.flash_attention_reference(*(torch.from_numpy(a)
                                              for a in qkv))[0]
        rtol, atol = fa.kernel_tolerance(torch.float32, want)
        k1 = fa.LAUNCHES
        ttu.check_consistency(
            lambda a, b, c: mx.nd.contrib.flash_attention(a, b, c), qkv,
            ctx_list=[mx.cpu(0), mx.gpu(0)], rtol=rtol, atol=atol)
        assert fa.LAUNCHES == k1 + 1
        # Steps of 1e-2 (chip_smoke.ORACLE's reasoning): K1's split TF32
        # sums are accurate to about 2^-20 a term.
        small = [rng.uniform(-1, 1, (1, 1, 16, 32)).astype(np.float32)
                 for _ in range(3)]
        before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        ttu.check_numeric_gradient(
            lambda a, b, c: mx.nd.contrib.flash_attention(a, b, c), small,
            eps=1e-2, ctx=mx.gpu(0))
        after = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        assert after[0] - before[0] == 1 + 2 * 3 * 16 * 32
        assert after[1] - before[1] == 1 and after[2] - before[2] == 1
    finally:
        restore()


@pytest.mark.cuda
def test_check_speed_on_the_card_times_the_kernels():
    """check_speed of the causal flash-attention symbol bound on gpu(0):
    ``whole`` runs K1, K2 and K3 each call and takes longer than
    ``forward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.ops import flash_attention as fa

    restore = _card_fp32()
    try:
        q, k, v = (mx.sym.var(n) for n in "qkv")
        sym = mx.sym.contrib.flash_attention(q, k, v, causal=True)
        shape = (2, 8, 1024, 64)
        before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        whole = ttu.check_speed(sym, ctx=mx.gpu(0), N=3, q=shape, k=shape,
                                v=shape)
        after = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        assert [a - b for a, b in zip(after, before)] == [4, 4, 4]
        fwd = ttu.check_speed(sym, ctx=mx.gpu(0), N=3, typ="forward",
                              q=shape, k=shape, v=shape)
        assert whole > fwd > 0
    finally:
        restore()
