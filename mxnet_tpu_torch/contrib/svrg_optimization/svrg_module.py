"""SVRGModule — Stochastic Variance Reduced Gradient training:
counterpart of ``mxnet_tpu/contrib/svrg_optimization/svrg_module.py``
(reference: python/mxnet/contrib/svrg_optimization/svrg_module.py,
implementing arXiv 1303.1170 / SVRG).

Every `update_freq` epochs the module snapshots the weights (w~) and
computes the full-dataset mean gradient at the snapshot; each batch
update then uses the variance-reduced gradient

    g = grad(w, batch) - grad(w~, batch) + full_grad(w~)

A second executor (`_mod_aux`) holds the snapshot weights and replays
every batch through them. The kvstore "full" key aggregation trick of
the reference is unnecessary locally: the rule is applied directly on
each executor's gradient buffers, on that executor's device, and the
full gradient is accumulated there too (no host copy). The
`_SVRGOptimizer` routing class is still provided for API/dist parity.
"""
from __future__ import annotations

import logging

from ...module import Module


class SVRGModule(Module):
    """Module with SVRG variance reduction (reference svrg_module.py:30).

    Parameters mirror Module plus `update_freq`: epochs between full
    gradient recomputations.
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None,
                 context=None, update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, context=context,
                         **kwargs)
        if not isinstance(update_freq, int) or update_freq < 1:
            raise ValueError("update_freq must be a positive int, got %r"
                             % (update_freq,))
        self.update_freq = update_freq
        self._mod_aux = Module(symbol, data_names=data_names,
                               label_names=label_names, context=context,
                               **kwargs)
        self._param_dict = None
        self._logger = logger or logging.getLogger(__name__)

    # -- lifecycle -----------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        super().bind(data_shapes, label_shapes, for_training,
                     inputs_need_grad, force_rebind, shared_module,
                     grad_req)
        if for_training:
            self._mod_aux.bind(data_shapes, label_shapes, for_training,
                               inputs_need_grad, force_rebind,
                               shared_module, grad_req)

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        super().init_params(initializer=initializer,
                            arg_params=arg_params, aux_params=aux_params,
                            allow_missing=allow_missing,
                            force_init=force_init)
        if self._mod_aux.binded:
            arg, aux = self.get_params()
            self._mod_aux.init_params(arg_params=arg, aux_params=aux,
                                      allow_missing=False)

    # -- per-batch flow ------------------------------------------------------

    def forward(self, data_batch, is_train=None):
        super().forward(data_batch, is_train)
        if (is_train if is_train is not None else self.for_training) \
                and self._mod_aux.binded:
            self._mod_aux.forward(data_batch, is_train=True)

    def backward(self, out_grads=None):
        super().backward(out_grads)
        if self._mod_aux.binded:
            self._mod_aux.backward(out_grads)

    def update(self):
        """Apply the SVRG rule to the gradient buffers, then run the
        standard parameter update (reference svrg_module.py:274)."""
        if self._param_dict is not None:
            self._update_svrg_gradients()
        super().update()

    # -- SVRG machinery ------------------------------------------------------

    def update_full_grads(self, train_data):
        """Snapshot current weights into the aux module and compute the
        mean full-dataset gradient at the snapshot
        (reference svrg_module.py:292). The sums stay on the
        executors' devices."""
        arg, aux = self.get_params()
        self._mod_aux.set_params(arg_params=arg, aux_params=aux)
        train_data.reset()
        accum = {name: None for name in self._param_names}
        nbatch = 0
        for batch in train_data:
            self._mod_aux.forward(batch, is_train=True)
            self._mod_aux.backward()
            for name in self._param_names:
                g = self._grad_of(self._mod_aux, name)
                accum[name] = g.copy() if accum[name] is None \
                    else accum[name] + g
            nbatch += 1
        if nbatch == 0:
            raise ValueError("update_full_grads: empty train_data")
        self._param_dict = {name: accum[name] / nbatch
                            for name in self._param_names}

    @staticmethod
    def _grad_of(mod, name):
        grads = [ex.grad_dict[name] for ex in mod._execs]
        total = grads[0]
        for g in grads[1:]:
            total = total + g.as_in_context(total.context)
        return total

    def _update_svrg_gradients(self):
        """grads = g(w, b) - g(w~, b) + full(w~)
        (reference svrg_module.py:360-393).

        Applied per executor with THAT executor's own aux grad and a
        1/n_exec share of the full gradient: Module.update then sums
        executor grads, recovering exactly sum(g) - g_aux + g_full —
        using the cross-executor totals per executor would over-count
        the correction n_exec times."""
        n = len(self._execs)
        for name in self._param_names:
            g_full = self._param_dict[name]
            for ex, ex_aux in zip(self._execs, self._mod_aux._execs):
                g = ex.grad_dict[name]
                g_aux = ex_aux.grad_dict[name]
                g[:] = g - g_aux.as_in_context(g.context) \
                    + (g_full / n).as_in_context(g.context)

    # -- training loop -------------------------------------------------------

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Module.fit with a full-gradient pass every `update_freq`
        epochs (reference svrg_module.py:395)."""
        assert num_epoch is not None, "please specify number of epochs"
        from ... import initializer as _init
        from ... import metric as _metric

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer or _init.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            if epoch % self.update_freq == 0:
                self.update_full_grads(train_data)
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward(data_batch, is_train=True)
                self.backward()
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    from ...callback import BatchEndParam

                    cbs = batch_end_callback if isinstance(
                        batch_end_callback, (list, tuple)) \
                        else [batch_end_callback]
                    for cb in cbs:
                        cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals()))
            for cb in (epoch_end_callback if isinstance(
                    epoch_end_callback, (list, tuple))
                    else [epoch_end_callback] if epoch_end_callback
                    else []):
                arg, aux = self.get_params()
                cb(epoch, self.symbol, arg, aux)
            if eval_data is not None:
                res = self.score(eval_data,
                                 validation_metric or eval_metric)
                for n, v in res:
                    self._logger.info("Epoch[%d] Validation-%s=%f",
                                      epoch, n, v)
