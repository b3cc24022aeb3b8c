"""Name management for symbol composition.

Counterpart of ``mxnet_tpu/name.py`` (reference python/mxnet/name.py):
a thread-local NameManager stack assigns auto names ``op0``, ``op1``,
...; Prefix prepends a scope prefix.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current_manager"]

_stack = threading.local()


def _current():
    st = getattr(_stack, "value", None)
    if st is None:
        st = _stack.value = [NameManager()]
    return st


def current_manager():
    return _current()[-1]


class NameManager:
    """Auto-naming scope (reference name.py:NameManager)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        cnt = self._counter.get(hint, 0)
        self._counter[hint] = cnt + 1
        return "%s%d" % (hint, cnt)

    def __enter__(self):
        _current().append(self)
        return self

    def __exit__(self, *exc):
        _current().pop()


class Prefix(NameManager):
    """Prefixing scope (reference name.py:Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name is not None else \
            self._prefix + super().get(None, hint)
