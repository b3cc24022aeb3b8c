"""DenseNet and VGG of the port's model zoo against the JAX package's,
from the same weights: inference-mode logits elementwise, hybridized
equal to imperative, and one train-mode step by relative L2 against the
port's float64 step (``tests/torch_zoo_parity.py`` states the limits).

DenseNet closes with ``AvgPool2D(7)``, so it runs at its standard 224 px,
batch 1; its depth and width are cut (``DenseNet(16, 8, [2, 2, 2, 2])``:
four dense blocks of two layers, the same ``_DenseLayer``, transition and
``stage%d_`` blocks as densenet121), because the JAX package compiles
each of densenet121's layer shapes on first use. vgg11_bn runs at 32 px,
batch 2.
"""
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision

from mxnet_tpu_torch.gluon.model_zoo import vision

import torch_zoo_parity as zoo

torch.set_num_threads(2)

DENSENET_CUT = (16, 8, [2, 2, 2, 2])
FAMILIES = {
    "densenet": (lambda v: (lambda **kw: v.DenseNet(*DENSENET_CUT, **kw)),
                 (1, 3, 224, 224)),
    "vgg11_bn": (lambda v: v.vgg11_bn, (2, 3, 32, 32)),
}


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, name):
    if name not in refs:
        make, shape = FAMILIES[name]
        refs[name] = zoo.jax_reference(make(jvision), shape)
    return refs[name]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_inference_forward_matches_jax(name, refs):
    zoo.check_eval_forward(FAMILIES[name][0](vision), _ref(refs, name))


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_train_step_matches_jax(name, hybridize, refs):
    zoo.check_train_step(FAMILIES[name][0](vision), _ref(refs, name),
                         hybridize)
