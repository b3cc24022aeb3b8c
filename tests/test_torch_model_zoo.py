"""The port's vision model zoo: the ``get_model`` table, pretrained
weights from a local file, and AlexNet and SqueezeNet against the JAX
package.

- Each of the JAX factory's 34 names builds in the port and gives (batch,
  classes) logits at a small input (the smallest each architecture
  takes: DenseNet 224 and Inception-v3 299 at batch 1);
- an unknown name raises the JAX package's ValueError, which lists the
  names;
- ``pretrained=True`` loads ``<name>.params`` from
  ``MXNET_TPU_MODEL_ZOO_DIR`` and raises FileNotFoundError naming the
  path without one; nothing is downloaded;
- alexnet and squeezenet1.1 (its pools ``ceil_mode``), 64 px at batch 2,
  match the JAX package from the same weights: inference-mode logits
  elementwise and one train-mode step by relative L2 against the port's
  float64 step (limits in ``tests/torch_zoo_parity.py``).

The other families are held in ``test_torch_model_zoo_{mobilenet,
densenet,inception}.py``, so that no worker carries them all.
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


def _side(name):
    if name.startswith("densenet"):
        return 1, 224
    if name == "inceptionv3":
        return 1, 299
    return 2, 64 if name.startswith(("alexnet", "squeezenet")) else 32


@pytest.mark.parametrize("name", sorted(vision._MODELS))
def test_every_name_builds_and_gives_logits(name):
    batch, side = _side(name)
    with mx.cpu(), mx.autograd.pause():
        net = vision.get_model(name, classes=7)
        net.initialize()
        out = net(mx.nd.array(np.random.RandomState(0).rand(
            batch, 3, side, side).astype(np.float32)))
    assert out.shape == (batch, 7)
    assert np.isfinite(out.asnumpy()).all()


def test_unknown_name_raises_value_error():
    """The same error as the JAX package's, whose message lists every
    name of its table: so the two tables hold the same 34 names."""
    assert len(vision._MODELS) == 34
    with pytest.raises(ValueError) as err:
        jvision.get_model("resnet999_v9")
    with pytest.raises(ValueError) as mine:
        vision.get_model("resnet999_v9")
    assert str(mine.value) == str(err.value)


@pytest.mark.parametrize("name", ["squeezenet1.1", "resnet18_v1"])
def test_pretrained_loads_a_local_params_file(name, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_MODEL_ZOO_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        vision.get_model(name, pretrained=True)
    x = mx.nd.array(np.random.RandomState(1).rand(1, 3, 64, 64)
                    .astype(np.float32), ctx=mx.cpu())
    with mx.cpu(), mx.autograd.pause():
        src = vision.get_model(name)
        src.initialize(mx.init.Xavier())
        want = src(x).asnumpy()
        src.save_parameters(os.path.join(str(tmp_path), name + ".params"))
        net = vision.get_model(name, pretrained=True, ctx=mx.cpu())
        got = net(x).asnumpy()
    np.testing.assert_array_equal(got, want)
    # An explicit root wins over the variable.
    with pytest.raises(FileNotFoundError, match="elsewhere"):
        vision.get_model(name, pretrained=True,
                         root=os.path.join(str(tmp_path), "elsewhere"))


FAMILIES = {"alexnet": (2, 3, 64, 64), "squeezenet1.1": (2, 3, 64, 64)}


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
