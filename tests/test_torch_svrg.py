"""``contrib.svrg_optimization`` of the port against the JAX package's.

The same linear-regression symbol, the same ``arg_params`` (numpy) and
the same unshuffled ``NDArrayIter`` go through both packages'
``SVRGModule`` with SGD and ``update_freq`` 2. Tolerances:

- the parameters after each of 4 epochs, rtol 1e-5 (atol 1e-7): the two
  packages' float32 GEMMs sum in other orders, so not bit for bit, and
  SVRG's correction g(w, b) - g(w~, b) + full cancels, which the epochs
  carry on;
- ``_param_dict`` after ``update_full_grads``, rtol 1e-6 (atol 1e-7);
- ``_SVRGOptimizer``'s routing and ``_AssignmentOptimizer``: exact;
- convergence on ``mx.cpu()`` as tests/test_text_svrg.py holds the JAX
  package (atol 0.25 on the weights).

The full gradient stays where the executors are: ``update_full_grads``
accumulates NDArrays on their context, never through the host.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib.svrg_optimization import SVRGModule as JSVRG
from mxnet_tpu_torch.contrib.svrg_optimization import (
    SVRGModule, _AssignmentOptimizer, _SVRGOptimizer)

torch.set_num_threads(2)

C = mx.cpu()
EPOCH_RTOL = 1e-5
FULL_RTOL = 1e-6


def _linreg_symbol(m):
    data = m.sym.var("data")
    out = m.sym.FullyConnected(data, num_hidden=1, name="fc")
    return m.sym.LinearRegressionOutput(out, name="lin_reg")


def _data(n=64, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    w = rng.uniform(-2, 2, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.randn(n)).astype(np.float32).reshape(-1, 1)
    return X, y


def _arg_params(d=5, seed=1):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.uniform(-0.1, 0.1, (1, d)).astype(np.float32),
            "fc_bias": np.zeros((1,), np.float32)}


def _iter(m, X, y, **kw):
    return m.io.NDArrayIter(X, y, batch_size=16, shuffle=False,
                            label_name="lin_reg_label", **kw)


def _module(m, cls, update_freq, **kw):
    return cls(_linreg_symbol(m), data_names=("data",),
               label_names=("lin_reg_label",), update_freq=update_freq,
               **kw)


def _fit(m, cls, X, y, arg, **kw):
    per_epoch = []

    def on_epoch(epoch, sym, a, aux):
        per_epoch.append({k: v.asnumpy() for k, v in a.items()})

    it = _iter(m, X, y, **kw)
    mod = _module(m, cls, 2, **({"context": kw["ctx"]} if kw else {}))
    mod.fit(it, num_epoch=4, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2},
            arg_params={k: m.nd.array(v, **kw) for k, v in arg.items()},
            eval_metric="mse", epoch_end_callback=on_epoch)
    return mod, per_epoch


def test_four_epochs_match_the_jax_package():
    X, y = _data()
    arg = _arg_params()
    tmod, tparams = _fit(mx, SVRGModule, X, y, arg, ctx=C)
    _, jparams = _fit(jmx, JSVRG, X, y, arg)
    assert len(tparams) == len(jparams) == 4
    for epoch, (t, j) in enumerate(zip(tparams, jparams)):
        for name in arg:
            np.testing.assert_allclose(
                t[name], j[name], rtol=EPOCH_RTOL, atol=1e-7,
                err_msg="%s after epoch %d" % (name, epoch))
        assert not np.array_equal(t["fc_weight"], arg["fc_weight"])
    assert tmod._param_dict["fc_weight"].context == C


def test_full_gradient_matches_and_stays_on_the_executors_context():
    X, y = _data(seed=2)
    arg = _arg_params(seed=3)
    full = {}
    for m, cls, kw in ((mx, SVRGModule, {"ctx": C}), (jmx, JSVRG, {})):
        it = _iter(m, X, y, **kw)
        mod = _module(m, cls, 1, **({"context": C} if kw else {}))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: m.nd.array(v, **kw)
                                    for k, v in arg.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.0})
        mod.update_full_grads(it)
        full[m.__name__] = {k: v for k, v in mod._param_dict.items()}
        if m is mx:
            for v in mod._param_dict.values():
                assert v.context == C
            # The mean of the per-batch gradients at the snapshot.
            it.reset()
            acc, nb = 0, 0
            for batch in it:
                mod._mod_aux.forward(batch, is_train=True)
                mod._mod_aux.backward()
                acc = acc + mod._mod_aux._execs[0].grad_dict[
                    "fc_weight"].asnumpy()
                nb += 1
            np.testing.assert_allclose(
                mod._param_dict["fc_weight"].asnumpy(), acc / nb,
                rtol=FULL_RTOL, atol=1e-7)
    for name in arg:
        np.testing.assert_allclose(
            full["mxnet_tpu_torch"][name].asnumpy(),
            full["mxnet_tpu"][name].asnumpy(), rtol=FULL_RTOL, atol=1e-7)


def test_first_update_after_a_snapshot_uses_the_full_gradient():
    """Right after ``update_full_grads`` the weights equal the snapshot,
    so g(w, b) - g(w~, b) vanishes and the corrected gradient is the
    full one."""
    X, y = _data(seed=4)
    it = _iter(mx, X, y, ctx=C)
    mod = _module(mx, SVRGModule, 2, context=C)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=C)
                                for k, v in _arg_params(seed=5).items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.update_full_grads(it)
    it.reset()
    batch = next(iter(it))
    mod.forward(batch, is_train=True)
    mod.backward()
    mod._update_svrg_gradients()
    for name, full in mod._param_dict.items():
        np.testing.assert_array_equal(
            mod._execs[0].grad_dict[name].asnumpy(), full.asnumpy())


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_svrg_optimizer_routing(pkg):
    """tests/test_text_svrg.py's routing case, in either package."""
    m = mx if pkg == "torch" else jmx
    opt_cls = _SVRGOptimizer if pkg == "torch" else \
        __import__("mxnet_tpu.contrib.svrg_optimization",
                   fromlist=["_SVRGOptimizer"])._SVRGOptimizer
    kw = {"ctx": C} if pkg == "torch" else {}
    opt = opt_cls("sgd", learning_rate=0.5,
                  param_idx2name={0: "w", 1: "w_full"})
    w = m.nd.array([1.0], **kw)
    opt.update(0, w, m.nd.array([0.5], **kw), opt.create_state(0, w))
    np.testing.assert_array_equal(w.asnumpy(), np.float32([0.75]))
    wf = m.nd.array([1.0], **kw)
    opt.update(1, wf, m.nd.array([0.125], **kw), opt.create_state(1, wf))
    np.testing.assert_array_equal(wf.asnumpy(), np.float32([0.125]))
    assert opt.create_state(1, wf) is None


def test_optimizers_are_registered_in_the_ports_registry():
    opt = mx.optimizer.create("_svrgoptimizer", default_optimizer="sgd",
                              learning_rate=0.25)
    assert isinstance(opt, _SVRGOptimizer)
    assert isinstance(opt.aux_opt, _AssignmentOptimizer)
    assert type(opt.default_opt).__name__ == "SGD"
    assert opt.default_opt.lr == 0.25
    w = mx.nd.zeros((3,), ctx=C)
    mx.optimizer.create("_AssignmentOptimizer").update(
        0, w, mx.nd.array([1.0, 2.0, 3.0], ctx=C), None)
    np.testing.assert_array_equal(w.asnumpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="update_freq"):
        _module(mx, SVRGModule, 0, context=C)


def test_svrg_module_converges_on_the_host():
    """tests/test_text_svrg.py's convergence case on ``mx.cpu()``."""
    rng = np.random.RandomState(0)
    n = 64
    X = rng.rand(n, 4).astype(np.float32)
    w_true = np.array([1.5, -2.0, 0.5, 3.0], np.float32)
    y = X @ w_true + 0.01 * rng.randn(n).astype(np.float32)
    it = mx.io.NDArrayIter(X, y.reshape(-1, 1), batch_size=16,
                           shuffle=True, label_name="lin_reg_label", ctx=C)
    mod = SVRGModule(_linreg_symbol(mx), data_names=("data",),
                     label_names=("lin_reg_label",), update_freq=2,
                     context=C)
    mod.fit(it, num_epoch=30, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, eval_metric="mse")
    arg, _ = mod.get_params()
    np.testing.assert_allclose(arg["fc_weight"].asnumpy().ravel(), w_true,
                               atol=0.25)
