"""BucketingModule — variable-length training via per-bucket executors.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference:
python/mxnet/module/bucketing_module.py — one Module per bucket key,
all sharing parameters via shared_module rebinds;
docs/faq/bucketing.md). As in the JAX package, each bucket binds its
own Executor and the weights are shared by copying through the default
bucket's arrays; the buckets share one updater. ``group2ctxs`` is
accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    """(reference bucketing_module.py:BucketingModule)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._optimizer_module = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        sym, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        sym, _, _ = self._call_sym_gen(self._default_bucket_key)
        return sym.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        out = self._sym_gen(bucket_key)
        if isinstance(out, tuple):
            return out
        return out, ("data",), ("softmax_label",)

    def _get_module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(sym, data_names, label_names, logger=self.logger,
                            context=self._context,
                            fixed_param_names=self._fixed_param_names)
            self._buckets[bucket_key] = module
        return self._buckets[bucket_key]

    def get_params(self):
        assert self.params_initialized
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (reference bucketing_module.py:bind)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        module = self._get_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=force_rebind,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """(reference bucketing_module.py:switch_bucket — rebind with
        shared weights; here weights copy through the default module)."""
        assert self.binded
        default = self._buckets[self._default_bucket_key]
        module = self._get_module(bucket_key)
        if not module.binded:
            module.bind(data_shapes, label_shapes, self.for_training,
                        shared_module=default)
        if not module.params_initialized and default.params_initialized:
            arg_params, aux_params = default.get_params()
            module.init_params(arg_params=arg_params, aux_params=aux_params,
                               allow_missing=False, force_init=True)
        if self.optimizer_initialized and not module.optimizer_initialized:
            self._borrow_optimizer(module)
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        self._optimizer_module = self._curr_module
        for module in self._buckets.values():
            if module is not self._curr_module and module.binded:
                self._borrow_optimizer(module)
        self.optimizer_initialized = True

    def _borrow_optimizer(self, module):
        """Share the optimizer and updater of the module that ran
        init_optimizer, whichever bucket was current then (a score
        before fit leaves another bucket current than the default; the
        JAX package borrows from the default bucket's module and then
        finds no updater, ROADMAP Queue 3)."""
        source = self._optimizer_module
        module._optimizer = source._optimizer
        module._updater = source._updater
        module._kvstore = source._kvstore
        module._update_on_kvstore = source._update_on_kvstore
        module.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key",
                             self._default_bucket_key)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        prev = self._curr_module
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        if prev is not self._curr_module and prev is not None and \
                prev.params_initialized:
            arg_params, aux_params = prev.get_params()
            self._curr_module.set_params(arg_params, aux_params)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()
        # propagate updated weights back to the default module so the
        # next bucket switch starts fresh
        default = self._buckets[self._default_bucket_key]
        if self._curr_module is not default:
            arg_params, aux_params = self._curr_module.get_params()
            default.set_params(arg_params, aux_params)

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._buckets.values():
            module.install_monitor(mon)
