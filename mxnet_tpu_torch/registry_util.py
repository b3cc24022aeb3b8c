"""Generic object registry (reference: python/mxnet/registry.py — the
get_register_func/get_create_func pattern used by optimizers, metrics,
initializers, iterators).

A copy of ``mxnet_tpu/registry_util.py``: the port imports nothing of
the JAX package, not even its modules that do not import JAX."""
from __future__ import annotations

__all__ = ["Registry"]


class Registry:
    def __init__(self, nickname):
        self.nickname = nickname
        self._registry = {}

    def register(self, name_or_cls, name=None):
        if isinstance(name_or_cls, str):
            reg_name = name_or_cls.lower()

            def deco(cls):
                self._registry[reg_name] = cls
                # first registration wins as canonical (for dumps());
                # __dict__ check so subclasses don't inherit the parent's
                # registry name
                if "_register_name" not in cls.__dict__:
                    cls._register_name = reg_name
                return cls

            return deco
        cls = name_or_cls
        reg_name = (name or cls.__name__).lower()
        self._registry[reg_name] = cls
        if "_register_name" not in cls.__dict__:
            cls._register_name = reg_name
        return cls

    def create(self, name, *args, **kwargs):
        if isinstance(name, str):
            key = name.lower()
            if key not in self._registry:
                raise ValueError("%s %r is not registered (have: %s)"
                                 % (self.nickname, name, sorted(self._registry)))
            return self._registry[key](*args, **kwargs)
        return name

    def get(self, name):
        return self._registry[name.lower()]

    def __contains__(self, name):
        return name.lower() in self._registry

    def keys(self):
        return list(self._registry)
