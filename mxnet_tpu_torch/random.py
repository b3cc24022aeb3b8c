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

In a process group (``parallel.dist``) rank ``r`` seeds its device
generators from the root seed and ``r`` (:func:`set_rank`; rank 0 keeps
the single-process stream), so two ranks draw different dropout masks
and a rerun repeats them; the host stream, which the initializers draw
from, stays the same on every rank, so every rank initializes the same
weights.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "for_device", "advance", "host_seed",
           "get_state", "set_state", "set_rank"]

_lock = threading.Lock()
_root_seed = 0
_counter = [0]
_rank = [0]
_generators: dict = {}  # torch.device -> torch.Generator


def _device_seed():
    r = _rank[0]
    if r == 0:
        return _root_seed
    return (_root_seed * 1000003 + r * 7919 + 0x5EED) & 0xFFFFFFFFFFFF


def set_rank(rank):
    """Make the device generators' stream this rank's: a function of
    the root seed and `rank` (``parallel.dist.initialize`` calls it);
    every device generator is reseeded."""
    with _lock:
        _rank[0] = int(rank)
        for gen in _generators.values():
            gen.manual_seed(_device_seed())


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
                gen.manual_seed(_device_seed())
        else:
            _generator_locked(ctx.torch_device).manual_seed(int(seed_state))


def _generator_locked(device):
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_device_seed())
        _generators[device] = gen
    return gen


def generator(ctx=None):
    """The torch.Generator of `ctx` (default: the current context)."""
    from .context import current_context

    device = (ctx if ctx is not None else current_context()).torch_device
    with _lock:
        return _generator_locked(device)


def for_device(device):
    """The torch.Generator of a ``torch.device`` (the RNG operators'
    draw, on the device their inputs live on)."""
    with _lock:
        return _generator_locked(torch.device(device))


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
