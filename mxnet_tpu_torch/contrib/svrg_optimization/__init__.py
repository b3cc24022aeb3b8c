"""SVRG optimization: counterpart of
``mxnet_tpu/contrib/svrg_optimization/__init__.py`` (reference:
python/mxnet/contrib/svrg_optimization/__init__.py)."""
from .svrg_module import SVRGModule
from .svrg_optimizer import _AssignmentOptimizer, _SVRGOptimizer

__all__ = ["SVRGModule", "_AssignmentOptimizer", "_SVRGOptimizer"]
