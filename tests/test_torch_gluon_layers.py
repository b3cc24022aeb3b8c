"""The port's gluon.nn layers of the core surface's second half against
the JAX package's.

For each of the 24 layers (InstanceNorm, LayerNorm, LeakyReLU, PReLU,
ELU, SELU, GELU, Swish, Lambda, HybridLambda; Conv1D, Conv3D, the three
ConvNDTranspose, the 1-D and 3-D max, average and global pools, and
ReflectionPad2D) the JAX layer is built and initialized, its parameters
set to seeded random values and carried to the port's layer with
``params_from_numpy``. The same seeded numpy input and head gradient
then go through both: the output, the input's gradient and every
trainable parameter's gradient must agree within rtol 1e-4 and atol
1e-5 * max|want| (fp32 in both; convolutions sum in different orders),
with the port's layer hybridized and not.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.utils import params_from_numpy

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-4, 1e-5

# name: (constructor arguments, input shape)
LAYERS = {
    "InstanceNorm": (dict(scale=True), (2, 3, 5, 5)),
    "LayerNorm": (dict(), (2, 4, 6)),
    "LeakyReLU": (dict(alpha=0.1), (2, 3, 4)),
    "PReLU": (dict(), (2, 3, 4, 4)),
    "ELU": (dict(alpha=0.7), (2, 3, 4)),
    "SELU": (dict(), (2, 3, 4)),
    "GELU": (dict(), (2, 3, 4)),
    "Swish": (dict(beta=1.5), (2, 3, 4)),
    "Lambda": (dict(function="tanh"), (2, 3, 4)),
    "HybridLambda": (dict(function="tanh"), (2, 3, 4)),
    "Conv1D": (dict(channels=4, kernel_size=3, strides=2, padding=1,
                    dilation=1), (2, 3, 9)),
    "Conv3D": (dict(channels=4, kernel_size=(2, 3, 3), padding=(0, 1, 1),
                    groups=2, activation="relu"), (2, 2, 4, 5, 5)),
    "Conv1DTranspose": (dict(channels=4, kernel_size=3, strides=2,
                             padding=1, output_padding=1), (2, 3, 6)),
    "Conv2DTranspose": (dict(channels=6, kernel_size=3, strides=2,
                             padding=1, output_padding=1, groups=2),
                        (2, 4, 5, 5)),
    "Conv3DTranspose": (dict(channels=2, kernel_size=3, strides=2),
                        (2, 3, 3, 3, 3)),
    "MaxPool1D": (dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 10)),
    "MaxPool3D": (dict(pool_size=2), (2, 2, 4, 4, 4)),
    "AvgPool1D": (dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 9)),
    "AvgPool3D": (dict(pool_size=2, padding=1), (2, 2, 4, 4, 4)),
    "GlobalMaxPool1D": (dict(), (2, 3, 7)),
    "GlobalMaxPool3D": (dict(), (2, 2, 3, 4, 5)),
    "GlobalAvgPool1D": (dict(), (2, 3, 7)),
    "GlobalAvgPool3D": (dict(), (2, 2, 3, 4, 5)),
    "ReflectionPad2D": (dict(padding=2), (2, 3, 5, 5)),
}
_REFS = {}


def _run(block, x, head, ns):
    """(output, input gradient, {relative name: parameter gradient})."""
    xa = ns.nd.array(x)
    xa.attach_grad()
    with ns.autograd.record():
        y = block(xa)
    y.backward(ns.nd.array(head))
    grads = {n: p.grad().asnumpy() for n, p in block.collect_params().items()
             if p.grad_req != "null"}
    return y.asnumpy(), xa.grad.asnumpy(), grads


def _reference(name):
    """(JAX prefix, {name: weights}, input, head, JAX results), once per
    layer and worker."""
    if name not in _REFS:
        kwargs, shape = LAYERS[name]
        rng = np.random.RandomState(sorted(LAYERS).index(name))
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        block = getattr(jnn, name)(**kwargs)
        block.initialize()
        with jmx.autograd.pause():
            y = block(jmx.nd.array(x))  # deferred shapes
        for p in block.collect_params().values():
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        arrays = {n: p.data().asnumpy()
                  for n, p in block.collect_params().items()}
        head = rng.uniform(-1, 1, y.shape).astype(np.float32)
        _REFS[name] = (block.prefix, arrays, x, head,
                       _run(block, x, head, jmx))
    return _REFS[name]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max() + 1e-30,
                               err_msg=what)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name, hybridize):
    prefix, arrays, x, head, (y_w, dx_w, dp_w) = _reference(name)
    with mx.cpu():
        block = getattr(nn, name)(**LAYERS[name][0])
        block.initialize()
        if arrays:
            block(mx.nd.array(x))  # deferred shapes
            params_from_numpy(block, arrays, prefix=prefix)
        block.hybridize(hybridize)
        y, dx, dp = _run(block, x, head, mx)
    _close(y, y_w, "%s output" % name)
    _close(dx, dx_w, "%s input gradient" % name)
    assert len(dp) == len(dp_w)
    for (n, g), w in zip(sorted(dp.items()), [dp_w[k] for k in sorted(dp_w)]):
        _close(g, w, "%s gradient of %s" % (name, n))


def test_every_public_layer_of_the_jax_package_exists():
    assert set(jnn.__all__) <= set(nn.__all__)
    for name in jnn.__all__:
        assert hasattr(nn, name), name


def test_transposed_conv_weight_is_input_channels_first():
    """A deferred transposed conv takes its weight's first axis from the
    input, as (in, out / groups, *kernel)."""
    with mx.cpu():
        block = nn.Conv2DTranspose(6, 3, groups=2)
        block.initialize()
        block(mx.nd.ones((1, 4, 5, 5)))
        assert block.weight.shape == (4, 3, 3, 3)
        conv = nn.Conv2D(6, 3, groups=2)
        conv.initialize()
        conv(mx.nd.ones((1, 4, 5, 5)))
        assert conv.weight.shape == (6, 2, 3, 3)


def test_prelu_alpha_and_lambda_resolution():
    with mx.cpu():
        prelu = nn.PReLU()
        prelu.initialize()
        assert prelu.alpha.shape == (1,)
        np.testing.assert_array_equal(prelu.alpha.data().asnumpy(), [0.25])
        x = mx.nd.array(np.array([[-2.0, 3.0]], np.float32))
        np.testing.assert_allclose(prelu(x).asnumpy(), [[-0.5, 3.0]])
        np.testing.assert_allclose(nn.Lambda("relu")(x).asnumpy(),
                                   [[0.0, 3.0]])
        fn = nn.HybridLambda(lambda F, a, b: F.broadcast_add(a, b))
        fn.hybridize()
        np.testing.assert_allclose(fn(x, x).asnumpy(), [[-4.0, 6.0]])


def test_sequential_slices_and_iterates():
    with mx.cpu():
        seq = nn.HybridSequential()
        seq.add(nn.Dense(3), nn.Activation("relu"), nn.Dense(2))
        head = seq[:2]
        assert isinstance(head, nn.HybridSequential) and len(head) == 2
        assert [type(b).__name__ for b in seq] == ["Dense", "Activation",
                                                  "Dense"]
