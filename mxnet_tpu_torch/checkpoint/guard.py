"""The step-in-progress guard: a checkpoint never mixes two steps.

The port has no counterpart module in the JAX package, which needs none:
its arrays are immutable, a step publishes its results in one attribute
store, and a snapshot taken mid-step sees donated (deleted) buffers and
raises. The port updates parameters and optimizer state in place, one
tensor at a time, and CPython runs a signal handler (``PreemptionHook``)
between any two bytecodes. A snapshot taken inside an update loop would
hold some tensors at step N and others at step N-1, under one label, and
a resume would apply part of one update twice without raising.

So every in-place update loop of the port — ``TrainStep.__call__``,
``gluon.Trainer.step``/``update`` (and the ``FusedApplier`` under them),
``Module.update`` — runs inside :func:`updating`, and every state
snapshot (``TrainStep.state_dict`` and the adapters of ``checkpoint``)
calls :func:`check` first. Inside the window, :func:`check` raises
:class:`StepInProgressError`; ``PreemptionHook`` then re-delivers the
signal after a short delay, as it does for the JAX package's raced
snapshot, and the retry sees the whole post-step state. The window is
process-wide: a snapshot raises while any update loop of the process is
open.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["StepInProgressError", "updating", "check"]

_lock = threading.Lock()
_open = [0]


class StepInProgressError(RuntimeError):
    """A state snapshot was asked for while an update loop was open."""


@contextlib.contextmanager
def updating():
    """Mark an in-place update loop (its step counter bump included)."""
    with _lock:
        _open[0] += 1
    try:
        yield
    finally:
        with _lock:
            _open[0] -= 1


def check(what="state"):
    """Raise StepInProgressError inside an update loop. Reads one int and
    takes no lock, so a signal handler may call it."""
    if _open[0]:
        raise StepInProgressError(
            "%s snapshot taken inside a training step's update loop: the "
            "state is part step N, part step N+1" % what)
