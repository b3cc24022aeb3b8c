"""Decode-pool autoscaling off the step-attribution signals.

Counterpart of ``mxnet_tpu/data/autoscale.py``, unchanged: the port's
``TrainStep`` records ``mx_train_step_seconds`` and the prefetcher
``mx_data_wait_seconds``, as in the JAX package.

A fixed ``decode_threads`` is wrong twice: oversized on a warm cache
(wasted host cores fighting the step thread for the GIL), undersized
the moment augmentation gets heavier (the accelerator starves and
``mx_step_bound{cause="input-bound"}`` lights up). This module closes
the loop the attribution plane opened: :class:`DecodeAutoscaler`
watches the **data-wait share of loop time** — the
``mx_data_wait_seconds`` / ``mx_train_step_seconds`` deltas the
pipeline and TrainStep already record, the same signal
``stall_fraction`` and the ``input_bound`` anomaly derive from — and
resizes the :class:`~mxnet_tpu_torch.data.decode.DecodePool` one worker at a
time with hysteresis:

* share ≥ ``grow_share`` (default 0.25 — the loop idles a quarter of
  its time on input) → grow by one, up to ``MXNET_DATA_MAX_WORKERS``;
* share ≤ ``shrink_share`` (default 0.05) → shrink by one, down to
  ``min_workers``;
* in between → hold (the hysteresis band prevents flapping: the two
  thresholds must be crossed, not hovered at).

One step per evaluation window is deliberate: decode throughput
responds to a worker with a lag of one in-flight window, so bigger
jumps overshoot and oscillate. The clock and the share source are both
injectable — the regression test drives the whole policy with a fake
clock and synthetic shares, no threads, no sleeps.
"""
from __future__ import annotations

import time

from ..telemetry import metrics as _tm
from .. import log as _log

__all__ = ["DecodeAutoscaler"]

_workers_gauge = _tm.REGISTRY.gauge(
    "mx_data_decode_workers",
    "Current decode-pool worker target (autoscaler-managed)")
_resizes_total = _tm.REGISTRY.counter(
    "mx_data_autoscale_total",
    "Decode-pool autoscaling actions", labels=("direction",))


def _default_max_workers():
    from .. import env as _env

    return int(_env.get("MXNET_DATA_MAX_WORKERS"))


class DecodeAutoscaler:
    """Grow/shrink a DecodePool off the data-wait share of step time.

    Parameters
    ----------
    pool : the :class:`~mxnet_tpu_torch.data.decode.DecodePool` to resize
        (anything with ``num_threads`` and ``resize(n)``).
    min_workers / max_workers : size bounds (max defaults to
        ``MXNET_DATA_MAX_WORKERS``).
    grow_share / shrink_share : hysteresis thresholds on the data-wait
        share of (data_wait + step) time per window.
    interval_s : evaluation window for :meth:`tick`.
    registry : metric source for the default share signal
        (``mx_data_wait_seconds`` + ``mx_train_step_seconds`` sums;
        default the process registry).
    clock : injectable clock.

    ``tick()`` from the consuming loop; or call :meth:`observe` with
    explicit (data_wait_s, step_s) window sums to drive the policy from
    your own measurements (what the tests do)."""

    def __init__(self, pool, min_workers=1, max_workers=None,
                 grow_share=0.25, shrink_share=0.05, interval_s=10.0,
                 registry=None, clock=time.monotonic):
        if grow_share <= shrink_share:
            raise ValueError(
                "grow_share must exceed shrink_share (hysteresis), got "
                "%r <= %r" % (grow_share, shrink_share))
        self.pool = pool
        self.min_workers = max(1, int(min_workers))
        self.max_workers = _default_max_workers() if max_workers is None \
            else int(max_workers)
        self.grow_share = float(grow_share)
        self.shrink_share = float(shrink_share)
        self.interval_s = float(interval_s)
        self._registry = registry or _tm.REGISTRY
        self._clock = clock
        self._last_tick = None
        self._last_wait = None      # cumulative sums at the last window
        self._last_step = None
        self.decisions = []         # (share, before, after) history
        _workers_gauge.set(int(pool.num_threads))

    # -- the policy -----------------------------------------------------------

    def observe(self, data_wait_s, step_s):
        """Evaluate one window's sums and apply at most one resize
        step. Returns the pool's (possibly new) worker count."""
        total = float(data_wait_s) + float(step_s)
        before = int(self.pool.num_threads)
        if total <= 0.0:
            return before       # idle window: no signal, no action
        share = float(data_wait_s) / total
        target = before
        if share >= self.grow_share:
            target = min(self.max_workers, before + 1)
        elif share <= self.shrink_share:
            target = max(self.min_workers, before - 1)
        if target != before:
            after = self.pool.resize(target)
            direction = "grow" if target > before else "shrink"
            _resizes_total.labels(direction=direction).inc()
            _workers_gauge.set(int(after))
            _log.get_logger("mxnet_tpu_torch.data").info(
                "decode autoscale: %s %d -> %d workers (data-wait "
                "share %.0f%%)", direction, before, after,
                share * 100.0)
        else:
            after = before
        self.decisions.append((share, before, after))
        return after

    def _sums(self):
        """Cumulative (data_wait_s, step_s) from the registry."""
        def total(name):
            fam = self._registry.get(name)
            if fam is None:
                return 0.0
            return sum(child.snapshot()["sum"]
                       for _, child in fam.collect())
        return total("mx_data_wait_seconds"), \
            total("mx_train_step_seconds")

    def tick(self, now=None):
        """Loop-cadence call: one :meth:`observe` per ``interval_s``
        over the registry deltas since the previous window. Never
        raises."""
        now = self._clock() if now is None else now
        if self._last_tick is not None and \
                now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now
        try:
            wait, step = self._sums()
        except Exception as exc:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.data"),
                "autoscale:%d" % id(self), 60.0,
                "decode autoscale signal read failed (will retry): %s",
                exc)
            return None
        if self._last_wait is None:
            # First window anchors the deltas — no decision yet.
            self._last_wait, self._last_step = wait, step
            return None
        d_wait = max(0.0, wait - self._last_wait)
        d_step = max(0.0, step - self._last_step)
        self._last_wait, self._last_step = wait, step
        return self.observe(d_wait, d_step)
