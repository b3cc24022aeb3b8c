"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``); the port has the
ResNet family so far."""
from .resnet import *  # noqa: F401,F403
from . import resnet

__all__ = resnet.__all__ + ["get_model"]

_MODELS = {"resnet%d_v%d" % (n, v): getattr(resnet, "resnet%d_v%d" % (n, v))
           for n in resnet.resnet_spec for v in (1, 2)}


def get_model(name, **kwargs):
    """Get a model by name (reference vision/__init__.py:get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %r not supported. Available: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
