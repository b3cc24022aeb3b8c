"""mx.monitor — per-layer output statistics during training: counterpart
of ``mxnet_tpu/monitor.py``.

Reference: python/mxnet/monitor.py (Monitor installs an executor monitor
callback; C++ side collects per-output tensors,
graph_executor.cc:103,1313) — here the callback rides
`Executor.set_monitor_callback`, which the executor invokes with every
named output after each forward. The statistic is computed where the
output is (on the card for a card executor); ``toc`` makes one host copy
per statistic.
"""
from __future__ import annotations

import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collect statistics of outputs matching `pattern` every `interval`
    batches (reference monitor.py:Monitor).

    Parameters
    ----------
    interval : batches between collections.
    stat_func : NDArray -> NDArray statistic (default: mean(|x|)).
    pattern : regex on output names.
    sort : sort the result list by name.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean()

        self.interval = interval
        self.stat_func = stat_func
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.queue = []
        self.step = 0
        self.activated = False
        self.exes = []

    def install(self, exe, monitor_all=False):
        """Attach to an executor (reference monitor.py:install →
        MXExecutorSetMonitorCallback)."""
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        if not isinstance(arr, NDArray):
            arr = NDArray(arr)
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        """Start collecting for this batch if the interval elapsed
        (reference monitor.py:tic)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; return [(step, name, stat_str)]
        (reference monitor.py:toc)."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        for step, name, stat in self.queue:
            if isinstance(stat, NDArray):
                stat = str(stat.asnumpy().reshape(-1))
            res.append((step, name, stat))
        if self.sort:
            res.sort(key=lambda x: x[1])
        self.queue = []
        return res

    def toc_print(self):
        """(reference monitor.py:toc_print)."""
        for step, name, stat in self.toc():
            print("Batch: %7d %30s %s" % (step, name, stat))
