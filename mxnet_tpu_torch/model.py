"""Model checkpoint helpers.

Counterpart of ``mxnet_tpu/model.py:19-49`` (reference
python/mxnet/model.py: save_checkpoint/load_checkpoint/load_params):
``prefix-symbol.json`` holds the graph, ``prefix-%04d.params`` the
weights under ``arg:``/``aux:`` keys. ``FeedForward`` and the
``_update_params`` seam wait for the rest of the symbolic stack
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "load_params"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (reference
    model.py:save_checkpoint; the same file layout)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch, ctx=None):
    """(arg_params, aux_params) of ``prefix-%04d.params``, on `ctx`
    (default: the current context) (reference model.py:load_params)."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) (reference
    model.py:load_checkpoint)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    return symbol, arg_params, aux_params
