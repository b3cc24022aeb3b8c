"""Module — symbolic training on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py — bind :364, init_optimizer :474, update
:644). ``bind`` makes one :class:`~mxnet_tpu_torch.executor.Executor`
through ``Symbol.simple_bind`` on the module's context; ``update`` runs
the optimizer through ``model._update_params`` with the port's
``FusedApplier`` (``MXNET_FUSED_UPDATE``, default on), bit for bit the
per-parameter updater, inside ``checkpoint.guard.updating()``: the
update writes weights and states in place, so a snapshot raises there
instead of mixing two steps.

What differs from the JAX package:

* A context list longer than one raises (ROADMAP Queue 1 item 7), as
  the port's Trainer does; so do ``dist*`` kvstores.
* Gradients are requested as the reference's executor group requests
  them: for the parameters that are not fixed, for the data only with
  ``inputs_need_grad``, never for the labels. (The JAX package computes
  every argument's gradient and skips the fixed ones at update.)
* ``Module.load`` arguments reach the executor at ``bind``, and its
  optimizer-state file at ``init_optimizer``, as in the reference, so
  ``Module.load(...)`` then ``fit(begin_epoch=...)`` resumes. The JAX
  package leaves both to an explicit ``init_params_from_preload`` and
  ``load_optimizer_states`` (ROADMAP Queue 3).
"""
from __future__ import annotations

import logging

import numpy as np

from .. import context as ctx_mod
from .. import env as _env
from .. import optimizer as opt
from ..checkpoint import guard as _guard
from ..model import _create_kvstore, _update_params, load_checkpoint
from .base_module import BaseModule

__all__ = ["Module"]


def _item7(what):
    return NotImplementedError(
        "%s: the port's Module runs on one context; data parallelism over "
        "several is ROADMAP Queue 1 item 7" % what)


class Module(BaseModule):
    """(reference module.py:Module)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = [ctx_mod.current_context()]
        if isinstance(context, ctx_mod.Context):
            context = [context]
        context = list(context)
        if len(context) != 1:
            raise _item7("Module over %d contexts %s"
                         % (len(context), context))
        self._context = context
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._preload_params = None
        self._execs = []
        self._data_shapes = None
        self._label_shapes = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._optimizer = None
        self._updater = None
        # None until init_optimizer: shared-module paths (Bucketing)
        # that install an updater directly take the per-param loop.
        self._fused_applier = None
        self._preload_opt_states = None
        self._preload_opt_state_blob = None
        self._grad_req = "write"
        self.inputs_need_grad = False

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """[(name, shape)] of the outputs, inferred from the bound input
        shapes (reference: the executor group's output shapes)."""
        assert self.binded
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return [(n, tuple(s)) for n, s in zip(self._output_names,
                                              out_shapes)]

    # -- bind -----------------------------------------------------------------

    def _grad_reqs(self, grad_req, inputs_need_grad):
        """Per-argument grad_req, as the reference's executor group
        builds it (executor_group.py:_bind_ith_exec)."""
        reqs = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                reqs[name] = grad_req if inputs_need_grad else "null"
            elif name in self._label_names or \
                    name in self._fixed_param_names:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req
        return reqs

    def _type_dict(self, data_shapes, label_shapes):
        """Each input's dtype from its DataDesc, and the parameters' and
        aux states' from the first data input (the reference infers them
        from the data's type): a float64 data desc binds a float64
        graph."""
        types = {getattr(d, "name", d[0]): np.dtype(getattr(d, "dtype",
                                                            np.float32))
                 for d in list(data_shapes) + list(label_shapes or [])}
        data_type = types[self._data_names[0]] if self._data_names else \
            np.dtype(np.float32)
        for name in self._param_names + self._aux_names:
            types[name] = data_type
        return {n: t.name for n, t in types.items()}

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """(reference module.py:bind :364)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req if for_training else "null"
        self._data_shapes = [(getattr(d, "name", d[0]),
                              tuple(getattr(d, "shape", d[1])))
                             for d in data_shapes]
        if label_shapes:
            self._label_shapes = [(getattr(l, "name", l[0]),
                                   tuple(getattr(l, "shape", l[1])))
                                  for l in label_shapes]
        else:
            self._label_shapes = None
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        self._batch_size = self._data_shapes[0][1][0]
        reqs = "null" if self._grad_req == "null" else \
            self._grad_reqs(self._grad_req, inputs_need_grad)
        self._execs = [self._symbol.simple_bind(
            ctx=self._context[0], grad_req=reqs,
            type_dict=self._type_dict(data_shapes, label_shapes), **shapes)]
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            arg_params, aux_params = shared_module.get_params()
            self.set_params(arg_params, aux_params)
        elif self._preload_params is not None:
            # Module.load / a restore onto an unbound module: the
            # reference installs the parameters at bind.
            arg_params, aux_params = self._preload_params
            self._preload_params = None
            self.init_params(arg_params=arg_params, aux_params=aux_params,
                             force_init=True)

    # -- params ---------------------------------------------------------------

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """(reference module.py:init_params). Missing values come from
        `initializer` (default ``Uniform(0.01)``) on host arrays, as in
        the JAX package."""
        from .. import initializer as _init

        assert self.binded, "call bind before init_params"
        if self.params_initialized and not force_init:
            return
        if initializer is None:
            initializer = _init.Uniform(0.01)

        self._arg_params = {}
        self._aux_params = {}
        ex = self._execs[0]
        sym_attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = ex.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            else:
                if arg_params is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                init_arr = np.zeros(arr.shape, dtype=np.float32)
                initializer(_init.InitDesc(name, sym_attrs.get(name, {})),
                            init_arr)
                arr[:] = init_arr
            self._arg_params[name] = arr.copy()
        for name in self._aux_names:
            arr = ex.aux_dict[name]
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            else:
                init_arr = np.zeros(arr.shape, dtype=np.float32)
                initializer(_init.InitDesc(name), init_arr)
                arr[:] = init_arr
            self._aux_params[name] = arr.copy()
        self.params_initialized = True

    def get_params(self):
        """(reference module.py:get_params) — copies of the executor's
        arrays."""
        assert self.binded and self.params_initialized
        ex = self._execs[0]
        arg_params = {n: ex.arg_dict[n].copy() for n in self._param_names}
        aux_params = {n: ex.aux_dict[n].copy() for n in self._aux_names}
        return arg_params, aux_params

    # -- optimizer ------------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """(reference module.py:init_optimizer :474)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            optimizer_params = dict(optimizer_params or {})
            # Normalize gradients by the batch size (reference
            # module.py:init_optimizer sets rescale_grad=1/batch_size).
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / self._batch_size
            optimizer = opt.create(optimizer, param_dict=None,
                                   **optimizer_params)
            optimizer.idx2name = idx2name
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        ctx0 = self._context[0]
        self._updater.state_ctx = lambda index: ctx0
        if _env.get("MXNET_FUSED_UPDATE"):
            from .. import fused_update as _fu

            self._fused_applier = _fu.FusedApplier(self._updater)
        else:
            self._fused_applier = None
        self._kvstore, self._update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), None)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            # Module.load(load_optimizer_states=True): the reference
            # applies the file here.
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        # Optimizer state restored (checkpoint.load_module_state) before
        # the optimizer existed: apply it now.
        if self._preload_opt_state_blob is not None:
            self._updater.set_states(self._preload_opt_state_blob)
            self._preload_opt_state_blob = None

    # -- compute --------------------------------------------------------------

    def forward(self, data_batch, is_train=None):
        """(reference module.py:forward)."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        ex = self._execs[0]
        feed = dict(zip(self._data_names, data_batch.data))
        for name, arr in zip(self._label_names, data_batch.label or []):
            if name in ex.arg_dict:
                feed[name] = arr
        ex.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._execs[0].backward(out_grads=out_grads)

    def update(self):
        """(reference module.py:update :644 → _update_params). Fixed
        params keep their updater index with a None entry."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        ex = self._execs[0]
        param_arrays, grad_arrays = [], []
        for name in self._param_names:
            if name in self._fixed_param_names:
                param_arrays.append(None)
                grad_arrays.append(None)
                continue
            param_arrays.append([ex.arg_dict[name]])
            grad_arrays.append([ex.grad_dict[name]])
        with _guard.updating():
            _update_params(param_arrays, grad_arrays, self._updater,
                           len(self._execs), applier=self._fused_applier)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = list(self._execs[0].outputs)
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        ex = self._execs[0]
        grads = [ex.grad_dict[name] for name in self._data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        for ex in self._execs:
            mon.install(ex)

    # -- checkpointing --------------------------------------------------------

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """(reference module.py:save_checkpoint)."""
        from ..model import save_checkpoint as _save

        arg_params, aux_params = self.get_params()
        _save(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """(reference module.py:load). The parameters are installed at
        ``bind`` and the optimizer-state file at ``init_optimizer``."""
        context = kwargs.get("context")
        if isinstance(context, (list, tuple)):
            context = context[0] if len(context) == 1 else None
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=context)
        mod = Module(symbol, **kwargs)
        mod._arg_params = arg_params
        mod._aux_params = aux_params
        mod._preload_params = (arg_params, aux_params)
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def init_params_from_preload(self):
        """Install the parameters of ``Module.load`` (JAX package API;
        ``bind`` already does it)."""
        if self._preload_params:
            arg, aux = self._preload_params
            self._preload_params = None
            self.init_params(arg_params=arg, aux_params=aux)

    def save_optimizer_states(self, fname):
        """The updater's state pickle, written atomically (a crash
        mid-save must not leave a truncated ``.states``)."""
        assert self.optimizer_initialized
        from ..base import atomic_write

        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer=False))

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        """(reference module.py:reshape — bucketing support)."""
        assert self.binded
        arg_params, aux_params = self.get_params()
        self.bind(data_shapes, label_shapes, self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True)
        self.set_params(arg_params, aux_params)

