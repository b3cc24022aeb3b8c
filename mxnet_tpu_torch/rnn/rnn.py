"""RNN checkpoint helpers (counterpart of ``mxnet_tpu/rnn/rnn.py``;
reference python/mxnet/rnn/rnn.py): ``model.save_checkpoint`` and
``load_checkpoint`` with the cells' ``unpack_weights``/``pack_weights``,
so fused and unfused cells share one file format (per-gate arrays), that
of the JAX package.
"""
from __future__ import annotations

from .. import model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """(reference rnn.py:save_rnn_checkpoint) — weights unpacked to
    per-gate arrays before saving."""
    for cell in _as_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """(reference rnn.py:load_rnn_checkpoint)."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback (reference rnn.py:do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
