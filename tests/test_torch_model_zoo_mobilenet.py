"""MobileNet V1 and V2 of the port's model zoo against the JAX package's,
from the same weights: inference-mode logits elementwise, hybridized
equal to imperative, and one train-mode step by relative L2 against the
port's float64 step (``tests/torch_zoo_parity.py`` states the limits).
Batch 2 at 64 px, at width 0.25 (``mobilenet0.25``,
``mobilenetv2_0.25``, whose blocks are those of the 1.0 nets), relu6 in
V2.
"""
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision

from mxnet_tpu_torch.gluon.model_zoo import vision

import torch_zoo_parity as zoo

torch.set_num_threads(2)

FAMILIES = {"mobilenet0.25": (2, 3, 64, 64),
            "mobilenetv2_0.25": (2, 3, 64, 64)}


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, name):
    if name not in refs:
        refs[name] = zoo.jax_reference(
            lambda **kw: jvision.get_model(name, **kw), FAMILIES[name])
    return refs[name]


def _make(name):
    return lambda **kw: vision.get_model(name, **kw)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_inference_forward_matches_jax(name, refs):
    zoo.check_eval_forward(_make(name), _ref(refs, name))


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_train_step_matches_jax(name, hybridize, refs):
    zoo.check_train_step(_make(name), _ref(refs, name), hybridize)
