"""SVRG optimizers: counterpart of
``mxnet_tpu/contrib/svrg_optimization/svrg_optimizer.py`` (reference:
python/mxnet/contrib/svrg_optimization/svrg_optimizer.py).

`_SVRGOptimizer` routes updates: indices whose resolved name contains
"full" hold the stored full gradients and get `_AssignmentOptimizer`
(weight := grad, a kvstore aggregation trick), everything else goes to
the wrapped default optimizer. Kept for API parity; `SVRGModule` in this
rebuild applies the variance-reduction rule directly on the gradient
buffers, so the routing optimizer is only exercised when a user drives
it manually the reference way. Both are registered in the port's
``optimizer`` registry.
"""
from __future__ import annotations

from ... import optimizer as _opt


@_opt.register
class _AssignmentOptimizer(_opt.Optimizer):
    """weight := grad (reference svrg_optimizer.py:26-48; used to park
    aggregated full gradients in kvstore slots)."""

    def update(self, index, weight, grad, state):
        weight[:] = grad

    def create_state(self, index, weight):
        return None


@_opt.register
class _SVRGOptimizer(_opt.Optimizer):
    """Wraps a default optimizer; routes "full"-named indices to
    `_AssignmentOptimizer` (reference svrg_optimizer.py:51-153)."""

    def __init__(self, default_optimizer, **kwargs):
        base = self._check_params(**kwargs)
        super().__init__(**base)
        if isinstance(default_optimizer, str):
            self.default_opt = _opt.create(default_optimizer, **kwargs)
        else:
            self.default_opt = default_optimizer
        self.aux_opt = _opt.create(_AssignmentOptimizer.__name__)

    @staticmethod
    def _check_params(**kwargs):
        base_params = ("rescale_grad", "param_idx2name", "wd",
                       "clip_gradient", "learning_rate", "lr_scheduler",
                       "begin_num_update", "multi_precision", "param_dict")
        return {k: v for k, v in kwargs.items() if k in base_params}

    def _name_of(self, index):
        return self.idx2name.get(index, str(index))

    def update(self, index, weight, grad, state):
        if "full" in self._name_of(index):
            self.aux_opt.update(index, weight, grad, state)
        else:
            self.default_opt.update(index, weight, grad, state)

    def create_state(self, index, weight):
        if "full" in self._name_of(index):
            return self.aux_opt.create_state(index, weight)
        return self.default_opt.create_state(index, weight)
