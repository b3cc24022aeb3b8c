"""Learning-rate schedulers.

Reference: python/mxnet/lr_scheduler.py (FactorScheduler,
MultiFactorScheduler, PolyScheduler, CosineScheduler, warmup support).
Same schedule semantics, derived in closed form from `num_update`
(updates are assumed monotone, as in the reference's training loops)
rather than replayed through per-call mutation loops.

A copy of ``mxnet_tpu/lr_scheduler.py`` (pure Python): the same
``num_update`` gives the same Python float in both packages.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: optional warmup ramp ahead of the schedule proper."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("invalid warmup_mode %s" % warmup_mode)
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        span = self.warmup_final_lr - self.warmup_begin_lr
        return self.warmup_begin_lr + span * num_update / self.warmup_steps

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr decays by `factor` once per `step` updates, floored at
    `stop_factor_lr` (reference FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._decays_done = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        # intervals fully crossed: a decay fires strictly AFTER each
        # full `step` window (update step+1 sees the first decay)
        due = max(0, math.ceil(num_update / self.step) - 1)
        fresh = due - self._decays_done
        if fresh > 0:
            self.base_lr = max(self.base_lr * self.factor ** fresh,
                               self.stop_factor_lr)
            self._decays_done = due
            self.count = due * self.step
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """One decay per crossed boundary in `step` (reference
    MultiFactorScheduler)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        crossed = sum(1 for b in self.step if num_update > b)
        fresh = crossed - self.cur_step_ind
        if fresh > 0:
            self.base_lr *= self.factor ** fresh
            self.count = self.step[crossed - 1]
            self.cur_step_ind = crossed
        return self.base_lr


def _schedule_fraction(num_update, warmup_steps, max_steps):
    """Position within the post-warmup schedule, clamped to [0, 1]
    (past max_update the schedule holds its final value)."""
    if max_steps <= 0:
        return 1.0
    return min(1.0, max(0.0, (num_update - warmup_steps) / max_steps))


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to final_lr over max_update
    (reference PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        remain = 1.0 - _schedule_fraction(num_update, self.warmup_steps,
                                          self.max_steps)
        self.base_lr = self.final_lr + \
            (self.base_lr_orig - self.final_lr) * remain ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Half-cosine anneal from base_lr to final_lr over max_update
    (reference CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        frac = _schedule_fraction(num_update, self.warmup_steps,
                                  self.max_steps)
        cos_out = 0.5 * (1.0 + math.cos(math.pi * frac))
        self.base_lr = self.final_lr + \
            (self.base_lr_orig - self.final_lr) * cos_out
        return self.base_lr
