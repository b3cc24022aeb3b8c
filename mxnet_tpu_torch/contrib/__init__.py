"""mx.contrib — companion packages.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference:
python/mxnet/contrib/). Present: ``io`` (DataLoaderIter, imported
eagerly) and ``quantization`` (int8 calibration, imported on first
use). ``text`` and ``svrg_optimization`` are not ported yet (ROADMAP
Queue 1 item 11c-3); reaching them raises.
"""
from . import io  # noqa: F401

_LAZY = ("quantization",)
_NOT_YET = ("text", "svrg_optimization")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if name in _NOT_YET:
        raise NotImplementedError(
            "mx.contrib.%s is not ported to mxnet_tpu_torch yet (ROADMAP "
            "Queue 1 item 11c-3)" % name)
    raise AttributeError("mx.contrib has no attribute %r" % name)
