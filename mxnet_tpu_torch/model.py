"""Model checkpoint helpers, BatchEndParam and FeedForward.

Counterpart of ``mxnet_tpu/model.py`` (reference python/model.py:
save_checkpoint/load_checkpoint/load_params, BatchEndParam,
_update_params, _create_kvstore and the legacy FeedForward API):
``prefix-symbol.json`` holds the graph, ``prefix-%04d.params`` the
weights under ``arg:``/``aux:`` keys.

The port updates on one context: ``_create_kvstore`` gives
``(None, False)`` for one device and a local store, so a Module updates
through its updater and the port's ``FusedApplier``; a ``dist*`` store
or several devices raise, naming ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _item7(what):
    return NotImplementedError(
        "%s: the port updates on one context; multi-device and dist_* "
        "kvstores are ROADMAP Queue 1 item 7" % what)


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


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   applier=None):
    """Local (non-kvstore) parameter update seam (reference
    model.py:_update_params).

    ``param_arrays``/``grad_arrays`` are per-parameter lists of
    per-device NDArrays; a ``None`` entry skips that index (fixed
    params). The port holds one device per parameter; ``num_device`` is
    accepted for the reference's signature. With ``applier`` (a
    ``fused_update.FusedApplier``) the eligible updates run fused, bit
    for bit the per-index loop, and only the remainder takes the
    per-param updater."""
    entries = []
    for index, (weights, grads) in enumerate(zip(param_arrays,
                                                 grad_arrays)):
        if weights is None or grads is None or not grads:
            continue
        if len(grads) > 1 or len(weights) > 1:
            raise _item7("_update_params over %d devices" % len(grads))
        entries.append((index, weights[0], grads[0]))
    pending = applier.apply(entries) if applier is not None else entries
    for index, weight, grad in pending:
        updater(index, grad, weight)


def _create_kvstore(kvstore, num_device, arg_params):
    """(reference model.py:_create_kvstore). Returns (kv,
    update_on_kvstore): ``(None, False)`` for no store or a local store
    on one device."""
    from . import kvstore as kvs

    if kvstore is None:
        return None, False
    if isinstance(kvstore, kvs.KVStore):
        name = kvstore.type
    elif isinstance(kvstore, str):
        name = kvstore
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if "dist" in name or num_device > 1:
        raise _item7("kvstore %r over %d device(s)" % (name, num_device))
    return None, False


class FeedForward:
    """Legacy training API (reference model.py:FeedForward — the
    pre-Module interface many reference examples use), a thin veneer
    over Module, as in the JAX package: fit/predict/score/save/load keep
    the historical signatures."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 epoch_size=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._opt_kwargs = {k: v for k, v in kwargs.items()
                            if k in ("learning_rate", "momentum", "wd",
                                     "rescale_grad", "clip_gradient",
                                     "lr_scheduler")}
        self._module = None

    def _init_module(self, data, label_names=None):
        from .module import Module

        labels = label_names or [n for n in self.symbol.list_arguments()
                                 if n.endswith("_label") or n == "label"]
        self._module = Module(self.symbol, context=self.ctx,
                              label_names=labels or None)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        """(reference model.py:FeedForward.fit)."""
        train_data = self._as_iter(X, y)
        mod = self._init_module(train_data)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self._opt_kwargs or
                (("learning_rate", 0.01),),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _as_iter(self, X, y=None, batch_size=128):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=min(batch_size, len(X)))

    def predict(self, X, num_batch=None):
        """(reference model.py:FeedForward.predict)."""
        data = self._as_iter(X)
        if self._module is None or not self._module.binded:
            mod = self._init_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label or None,
                     for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
        outs = self._module.predict(data, num_batch=num_batch)
        out = outs[0] if isinstance(outs, list) else outs
        return out.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None):
        from . import metric as _metric

        data = self._as_iter(X)
        m = _metric.create(eval_metric) if isinstance(eval_metric, str) \
            else eval_metric
        return self._module.score(data, m, num_batch=num_batch)[0][1]

    def save(self, prefix, epoch=None):
        """(reference model.py:FeedForward.save)."""
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """(reference model.py:FeedForward.load)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, **kwargs):
        """(reference model.py:FeedForward.create — construct + fit)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        model.fit(X, y)
        return model
