"""Autograd mode flags.

Counterpart of the scope half of ``mxnet_tpu/autograd.py``
(autograd.py:47-99): ``record``, ``pause``, ``train_mode``,
``predict_mode`` and the ``is_recording``/``is_training`` queries that
train-aware ops (BatchNorm) read. The tape and ``backward`` come with
the training slice of the port.
"""
from __future__ import annotations

import threading

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    st = _st()
    prev, st.recording = st.recording, flag
    return prev


def set_training(flag):
    st = _st()
    prev, st.training = st.training, flag
    return prev


class _RecordingScope:
    def __init__(self, recording, training):
        self._recording = recording
        self._training = training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._prev

    def __call__(self, fn):
        def wrapped(*args, **kwargs):
            with self.__class__(self._recording, self._training):
                return fn(*args, **kwargs)

        return wrapped


def record(train_mode=True):
    """Scope in which ops run in recording (and by default train) mode."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)
