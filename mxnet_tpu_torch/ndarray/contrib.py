"""`mx.nd.contrib` — the contrib operator namespace.

Counterpart of the namespace half of ``mxnet_tpu/ndarray/contrib.py``:
``nd.contrib.<name>`` resolves the registered ``_contrib_<name>``, then
``<name>``. The control-flow helpers (foreach, while_loop, cond) come
with a later slice.
"""
from __future__ import annotations

from ..ops import registry as _registry


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import __getattr__ as _nd_getattr

    for candidate in ("_contrib_" + name, name):
        try:
            _registry.get(candidate)
        except AttributeError:
            continue
        return _nd_getattr(candidate)
    raise AttributeError("contrib operator %r is not registered" % name)
