"""Attribute scoping for symbols.

Counterpart of ``mxnet_tpu/attribute.py`` (reference
python/mxnet/attribute.py, AttrScope): a context manager that stamps
attributes, most importantly ``ctx_group``, onto every symbol created
inside the scope; ``bind(group2ctx=...)`` places each group's ops on its
device (see ``executor.py``).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_scope = threading.local()


class AttrScope:
    """Attach attributes to all symbols created within the scope.

    Example::

        with AttrScope(ctx_group="dev1"):
            h = mx.sym.FullyConnected(x, num_hidden=128)
    """

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes need to be strings")
        self._attrs = kwargs

    def __enter__(self):
        stack = getattr(_scope, "stack", None)
        if stack is None:
            stack = _scope.stack = []
        merged = dict(stack[-1]) if stack else {}
        merged.update(self._attrs)
        stack.append(merged)
        return self

    def __exit__(self, *args):
        _scope.stack.pop()


def current_attrs():
    """Attributes of the innermost active AttrScope (merged), or {}."""
    stack = getattr(_scope, "stack", None)
    return dict(stack[-1]) if stack else {}
