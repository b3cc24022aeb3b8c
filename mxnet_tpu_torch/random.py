"""Random state management.

Counterpart of ``mxnet_tpu/random.py`` (reference: per-device RNG
resources with ``mx.random.seed``). The JAX package derives stateless
threefry keys from a root seed and a counter; the port keeps one
``torch.Generator`` per device, created on first use and seeded from
the root seed, plus the same host-side (seed, counter) stream that the
initializers draw from. The two packages give different numbers from
the same seed, so the parity tests hand both the same numpy inputs.

``get_state``/``set_state`` capture and restore the whole position:
root seed, host counter and every device generator's state, so that a
resumed run draws what the uninterrupted run would have drawn.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "advance", "host_seed", "get_state",
           "set_state"]

_lock = threading.Lock()
_root_seed = 0
_counter = [0]
_generators: dict = {}  # torch.device -> torch.Generator


def seed(seed_state, ctx="all"):
    """Reference: mx.random.seed. With ``ctx="all"`` resets the root
    seed, the host counter and every device generator; with a Context,
    reseeds that device's generator only."""
    global _root_seed
    with _lock:
        if ctx == "all":
            _root_seed = int(seed_state)
            _counter[0] = 0
            for gen in _generators.values():
                gen.manual_seed(_root_seed)
        else:
            _generator_locked(ctx.torch_device).manual_seed(int(seed_state))


def _generator_locked(device):
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_root_seed)
        _generators[device] = gen
    return gen


def generator(ctx=None):
    """The torch.Generator of `ctx` (default: the current context)."""
    from .context import current_context

    device = (ctx if ctx is not None else current_context()).torch_device
    with _lock:
        return _generator_locked(device)


def advance():
    """Advance the host counter (host-side consumers such as parameter
    initializers call it so that successive draws differ)."""
    with _lock:
        _counter[0] += 1


def host_seed():
    """A 32-bit seed for a host-side generator (an iterator's shuffle,
    an augmenter stream), drawn from the root seed and the host counter,
    which it advances: successive generators differ, and ``seed(s)``
    makes them repeat."""
    with _lock:
        counter = _counter[0]
        _counter[0] += 1
        root = _root_seed
    return (root * 1000003 + counter * 7919 + 17) & 0xFFFFFFFF


def get_state():
    """(root seed, host counter, {device: generator state})."""
    with _lock:
        return (_root_seed, _counter[0],
                {str(d): g.get_state() for d, g in _generators.items()})


def set_state(seed_state, counter, generator_states=None):
    """Restore a position captured by :func:`get_state`."""
    global _root_seed
    with _lock:
        _root_seed = int(seed_state)
        _counter[0] = int(counter)
        for name, state in (generator_states or {}).items():
            _generator_locked(torch.device(name)).set_state(state)
