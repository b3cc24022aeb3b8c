"""Training callbacks (reference: python/mxnet/callback.py — Speedometer,
do_checkpoint, ProgressBar, LogValidationMetricsCallback; invoked by
module/base_module.py:fit per batch / per epoch).

Counterpart of ``mxnet_tpu/callback.py``. ``do_checkpoint`` writes
through the port's ``model.save_checkpoint`` or, with ``manager=``, a
``checkpoint.CheckpointManager``; ``module_checkpoint`` saves a
``Module`` either way. ``TelemetryCallback`` records into the port's
``telemetry.REGISTRY`` and drives any ``monitor``/ticker object it is
given.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "ProgressBar", "TelemetryCallback",
           "do_checkpoint", "log_train_metric", "module_checkpoint",
           "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False,
                      manager=None):
    """Epoch-end callback checkpointing a module (reference
    callback.py:module_checkpoint).

    With ``manager`` (a ``checkpoint.CheckpointManager``), saves go
    through the fault-tolerant async path instead of blocking file
    writes: params (+ optimizer states when requested) are copied at the
    epoch boundary and committed atomically off the critical path;
    `prefix` is unused. Restore with ``manager.restore()`` +
    ``checkpoint.load_state_dict(mod, state)``."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period != 0:
            return
        if manager is not None:
            from .checkpoint import module_state

            manager.save(iter_no + 1, module_state(
                mod, include_optimizer=save_optimizer_states))
        else:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1, manager=None):
    """Epoch-end callback saving `prefix-symbol.json` +
    `prefix-%04d.params` (reference callback.py:do_checkpoint →
    model.save_checkpoint).

    With ``manager`` (a ``checkpoint.CheckpointManager``), the symbol
    JSON + arg/aux params are committed atomically by the async manager
    instead of written inline; `prefix` is unused."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        from .model import save_checkpoint

        if (iter_no + 1) % period != 0:
            return
        if manager is not None:
            manager.save(iter_no + 1, {
                "symbol": sym.tojson() if sym is not None else "",
                "arg": dict(arg or {}), "aux": dict(aux or {})})
        else:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running metric every `period`
    batches (reference callback.py:log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec and metrics every `frequent` batches (reference
    callback.py:Speedometer). A timing window opens on the first batch
    of each epoch (batch counters restarting signal a new epoch) and
    closes/reopens at every `frequent`-batch boundary."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None     # perf-clock time, None = no window
        self._prev_batch = -1

    def _report(self, param, speed):
        metric = param.eval_metric
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
            return
        pairs = metric.get_name_value()
        if self.auto_reset:
            metric.reset()
        parts = ["Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                 % (param.epoch, param.nbatch, speed)]
        parts.extend("%s=%f" % (n, v) for n, v in pairs)
        logging.info("\t".join(parts))

    def __call__(self, param):
        batch = param.nbatch
        if batch < self._prev_batch:          # counter restarted: new epoch
            self._window_start = None
        self._prev_batch = batch

        if self._window_start is None:
            self._window_start = time.time()
            return
        if batch % self.frequent != 0:
            return
        elapsed = time.time() - self._window_start
        if elapsed > 0:
            self._report(param, self.frequent * self.batch_size / elapsed)
        self._window_start = time.time()


class TelemetryCallback:
    """Speedometer-shaped batch-end callback that feeds the unified
    telemetry registry instead of (only) the log:

    * ``mx_train_batch_seconds`` histogram — inter-batch wall time;
    * ``mx_train_batches_total`` / ``mx_train_samples_total`` counters;
    * optional :class:`telemetry.StepMonitor` (``monitor=``) — every
      batch time feeds ``observe_step``;
    * every ``frequent`` batches, a Speedometer-style samples/sec line
      (``frequent=0`` disables logging; the metrics still record);
    * optional tickers (``trace_writer=``, ``aggregator=``, ``slo=``):
      any objects with ``tick()``, each driven once per batch.

    Use anywhere a ``batch_end_callback`` goes, or call it from a
    training loop with any object exposing ``epoch``/``nbatch``/
    ``eval_metric``::

        cb = callback.TelemetryCallback(batch_size)
        for i, (x, y) in enumerate(batches):
            loss = train_step(x, y)
            cb(types.SimpleNamespace(epoch=0, nbatch=i, eval_metric=None))
    """

    def __init__(self, batch_size, frequent=50, monitor=None,
                 trace_writer=None, aggregator=None, slo=None):
        from . import telemetry as _telemetry

        self.batch_size = int(batch_size)
        self.frequent = int(frequent)
        self.monitor = monitor
        self._tickers = [t for t in (trace_writer, aggregator, slo)
                         if t is not None]
        reg = _telemetry.REGISTRY
        self._batch_seconds = reg.histogram(
            "mx_train_batch_seconds",
            "Inter-batch wall time seen by TelemetryCallback")
        self._batches = reg.counter("mx_train_batches_total",
                                    "Batches completed")
        self._samples = reg.counter("mx_train_samples_total",
                                    "Samples trained")
        self._t_prev = None
        self._prev_batch = -1
        self._window_time = 0.0
        self._window_batches = 0

    def __call__(self, param):
        now = time.perf_counter()
        batch = param.nbatch
        if batch < self._prev_batch:      # counter restarted: new epoch
            self._t_prev = None
        self._prev_batch = batch
        # Batch/sample counters tick for EVERY batch; only the timing
        # path needs a previous batch to diff against.
        self._batches.inc()
        self._samples.inc(self.batch_size)
        for ticker in self._tickers:
            ticker.tick()
        if self._t_prev is None:
            self._t_prev = now
            return
        dt = now - self._t_prev
        self._t_prev = now
        self._batch_seconds.observe(dt)
        if self.monitor is not None:
            self.monitor.observe_step(dt, step=batch)
        self._window_time += dt
        self._window_batches += 1
        if self.frequent and batch % self.frequent == 0 \
                and self._window_time > 0:
            speed = self._window_batches * self.batch_size \
                / self._window_time
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                         "\t(telemetry)", param.epoch, batch, speed)
            self._window_time = 0.0
            self._window_batches = 0


class ProgressBar:
    """ASCII progress bar per batch (reference callback.py:ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback logging validation metrics (reference
    callback.py:LogValidationMetricsCallback)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
