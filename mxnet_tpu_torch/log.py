"""Colored logging helpers (reference: python/mxnet/log.py).

A copy of ``mxnet_tpu/log.py``, which imports no JAX.

`get_logger(name, filename, filemode, level)` returns a logger with the
reference's level-labelled formatter; terminal streams get ANSI colors.
"""
from __future__ import annotations

import logging
import sys
import threading
import time

__all__ = ["get_logger", "getLogger", "warn_rate_limited", "DEBUG",
           "INFO", "WARNING", "ERROR", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

_COLORS = {logging.WARNING: "\x1b[0;33m", logging.ERROR: "\x1b[0;31m",
           logging.INFO: "\x1b[0;32m", logging.DEBUG: "\x1b[0;34m"}
_LABELS = {logging.WARNING: "W", logging.ERROR: "E", logging.INFO: "I",
           logging.DEBUG: "D"}


class _Formatter(logging.Formatter):
    """Level-labelled (optionally colored) record format
    (reference log.py:37)."""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        label = _LABELS.get(record.levelno, "U")
        if self._colored and record.levelno in _COLORS:
            label = _COLORS[record.levelno] + label + "\x1b[0m"
        self._style._fmt = label + "%(asctime)s %(process)d %(pathname)s" \
            ":%(lineno)d] %(message)s"
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Logger with the reference formatter (reference log.py:90)."""
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        logger.setLevel(level)
        return logger
    logger._init_done = True
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        colored = False
    else:
        handler = logging.StreamHandler(sys.stderr)
        colored = getattr(sys.stderr, "isatty", lambda: False)()
    handler.setFormatter(_Formatter(colored))
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


_rate_lock = threading.Lock()
_rate_last = {}     # key -> last-emit time


def warn_rate_limited(logger, key, interval_s, msg, *args, now=None):
    """Emit ``logger.warning(msg, *args)`` at most once per
    ``interval_s`` seconds per ``key``; suppressed repeats are counted
    and reported on the next emitted line. Used by the telemetry
    step-health monitor so an anomaly storm (every step suddenly slow)
    warns once per window instead of flooding the log. ``now`` injects a
    clock for tests (default ``time.monotonic``). Returns True when the
    warning was emitted."""
    t = time.monotonic() if now is None else now
    with _rate_lock:
        last, suppressed = _rate_last.get(key, (None, 0))
        if last is not None and t - last < interval_s:
            _rate_last[key] = (last, suppressed + 1)
            return False
        _rate_last[key] = (t, 0)
    if suppressed:
        msg = msg + " (+%d suppressed since last report)" % suppressed
    logger.warning(msg, *args)
    return True


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias (reference log.py:80)."""
    import warnings

    warnings.warn("getLogger is deprecated, use get_logger instead",
                  DeprecationWarning)
    return get_logger(name, filename, filemode, level)
