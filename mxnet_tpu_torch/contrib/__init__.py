"""mx.contrib — companion packages.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference:
python/mxnet/contrib/). ``io`` (DataLoaderIter) is imported eagerly;
``quantization`` (int8 calibration), ``text`` (vocabularies and token
embeddings) and ``svrg_optimization`` (SVRGModule) on first use.
"""
from . import io  # noqa: F401

_LAZY = ("quantization", "text", "svrg_optimization")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("mx.contrib has no attribute %r" % name)
