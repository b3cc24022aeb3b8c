"""Inception-v3 of the port's model zoo against the JAX package's, from
the same weights, at its standard 299 px, batch 1 (its closing
``AvgPool2D(8)`` needs the 8x8 map): inference-mode logits elementwise,
hybridized equal to imperative, and one train-mode step by relative L2
against the port's float64 step (``tests/torch_zoo_parity.py`` states
the limits). Then one ``export`` -> ``SymbolBlock.imports`` round trip
(branches, ``Concat``, BatchNorm's aux states) equal to the live net.
"""
import os

import numpy as np
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision

import torch_zoo_parity as zoo

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    return zoo.jax_reference(jvision.inception_v3, (1, 3, 299, 299))


def test_inception_inference_forward_matches_jax(ref):
    zoo.check_eval_forward(vision.inception_v3, ref)


@pytest.mark.parametrize("hybridize", [False, True])
def test_inception_train_step_matches_jax(ref, hybridize):
    zoo.check_train_step(vision.inception_v3, ref, hybridize)


def test_inception_export_imports_round_trip(ref, tmp_path):
    net = zoo.port_net(vision.inception_v3, ref)
    x = mx.nd.array(ref["x"], ctx=mx.cpu())
    with mx.cpu(), mx.autograd.pause():
        want = net(x).asnumpy()
        sym_file, params_file = net.export(os.path.join(str(tmp_path),
                                                        "inception"))
        back = mx.gluon.SymbolBlock.imports(sym_file, "data", params_file,
                                            ctx=mx.cpu())
        got = back(x).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
