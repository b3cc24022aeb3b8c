"""One model-zoo network through the JAX package and the port from the
same weights (shared by ``tests/test_torch_model_zoo*.py``).

The JAX net takes one recorded train-mode forward and backward of the
summed softmax cross-entropy on a seeded batch; that call also fixes
its deferred shapes, and its weights (the running statistics as they
were before it) are carried to the port's net with
``params_from_numpy``. Then, with the BatchNorm statistics set to seeded
random values in both, an inference-mode forward.

Dropout draws its masks from each package's own generator, so the
train-mode step runs with every Dropout layer's rate set to 0 in both
nets (inference mode has no dropout).

What is compared, and how closely:
- inference-mode logits, per element: rtol 1e-4, atol 1e-5 of the
  largest logit (fp32 in both; convolutions sum in different orders,
  and the error grows with depth); the port's hybridized forward equals
  its imperative one within 1e-6;
- the train-mode step, against the port's float64 step from the same
  state, part by part, each by its relative L2 error over the whole net:
  - its logits and the running statistics after it: the JAX package's
    fp32 values within 0.1 (which holds the float64 port to the JAX
    package), and the port's no farther than twice the JAX package's,
    or 1e-4;
  - the gradients of the input and of every trainable parameter: the
    JAX package's and the port's fp32 gradients each within 0.1. In
    train mode at batch 1-2 an fp32 gradient of the deep nets is itself
    a few percent from the float64 one (BatchNorm's backward sums large
    terms that cancel, over few statistics at a 2x2 map and batch 2),
    and a ReLU input within rounding of zero can take the other side in
    one run and move the gradients upstream of it by percents; so fp32
    gradients are compared neither elementwise nor with each other (as
    in ``tests/test_torch_train_step.py``).
"""
import numpy as np

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

RTOL, ATOL_REL = 1e-4, 1e-5
F32_REL_L2, PORT_F32_RATIO, PORT_F32_FLOOR = 0.1, 2.0, 1e-4
_STATS = ("running_mean", "running_var")


def _without_dropout(net):
    """`net` with the rate of each Dropout layer in it set to 0."""
    todo = [net]
    while todo:
        block = todo.pop()
        if type(block).__name__ == "Dropout":
            block._rate = 0.0
        todo.extend(block._children.values())
    return net


def _step(net, x, y, ns, dtype="float32"):
    """Train-mode logits, input gradient and {name: grad} of one
    recorded forward and backward."""
    xa = ns.nd.array(x, dtype=dtype)
    xa.attach_grad()
    loss_fn = ns.gluon.loss.SoftmaxCrossEntropyLoss()
    with ns.autograd.record():
        out = net(xa)
        loss = loss_fn(out, ns.nd.array(y, dtype=dtype)).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xa.grad.asnumpy(), grads


def _stats(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()
            if n.endswith(_STATS)}


def _randomized_stats(net, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for n, p in sorted(net.collect_params().items()):
        if n.endswith("running_mean"):
            out[n] = rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
        elif n.endswith("running_var"):
            out[n] = rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
    return out


def jax_reference(make_jax, shape, seed=0, classes=10):
    """Everything the port's net is compared with, from the JAX net that
    `make_jax(classes=...)` builds."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.randint(0, classes, shape[0]).astype(np.float32)
    jmx.random.seed(seed)
    net = _without_dropout(make_jax(classes=classes))
    net.initialize(jmx.init.Xavier())
    # Deferred shapes need one call: make it the train-mode step, after
    # which the running statistics are put back to their start.
    logits, dx, grads = _step(net, x, y, jmx)
    stats_after = _stats(net)
    stats_before = {n: (np.zeros_like(v) if n.endswith("running_mean")
                        else np.ones_like(v))
                    for n, v in stats_after.items()}
    arrays = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    arrays.update(stats_before)
    eval_stats = _randomized_stats(net, seed + 1)
    for n, v in eval_stats.items():
        net.collect_params()[n].set_data(v)
    with jmx.autograd.pause():
        eval_logits = net(jmx.nd.array(x)).asnumpy()
    rel = relative_names(list(arrays), net.prefix)
    return {"prefix": net.prefix, "arrays": arrays, "x": x, "y": y,
            "logits": logits, "dx": dx,
            "grads": {rel[n]: g for n, g in grads.items()},
            "stats_after": {rel[n]: v for n, v in stats_after.items()},
            "eval_stats": {rel[n]: v for n, v in eval_stats.items()},
            "eval_logits": eval_logits}


def port_net(make_port, ref, classes=10):
    with mx.cpu():
        net = make_port(classes=classes)
        net.initialize()
        params_from_numpy(net, ref["arrays"], prefix=ref["prefix"])
    return net


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max() + 1e-30,
                               err_msg=what)


def _rel_l2(got, want):
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum())
              for k in want)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
    return np.sqrt(num / den)


def _port_step(make_port, ref, hybridize=False, dtype="float32"):
    """{"logits", "grads" (the input's under "<input>"), "stats"} of the
    port's step from the reference state, by relative name."""
    net = _without_dropout(port_net(make_port, ref))
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize(hybridize)
    with mx.cpu():
        logits, dx, grads = _step(net, ref["x"], ref["y"], mx, dtype)
    rel = relative_names(list(net.collect_params().keys()), net.prefix)
    return {"logits": {"": logits},
            "grads": dict({rel[n]: g for n, g in grads.items()},
                          **{"<input>": dx}),
            "stats": {rel[n]: v for n, v in _stats(net).items()}}


def check_train_step(make_port, ref, hybridize):
    if "step64" not in ref:
        ref["step64"] = _port_step(make_port, ref, dtype="float64")
    exact = ref["step64"]
    got = _port_step(make_port, ref, hybridize)
    want = {"logits": {"": ref["logits"]},
            "grads": dict(ref["grads"], **{"<input>": ref["dx"]}),
            "stats": ref["stats_after"]}
    for part in ("logits", "grads", "stats"):
        if not want[part]:
            continue
        assert set(got[part]) == set(want[part]) == set(exact[part]), part
        err_jax = _rel_l2(want[part], exact[part])
        err_port = _rel_l2(got[part], exact[part])
        assert err_jax < F32_REL_L2, "JAX fp32 %s vs port float64: " \
            "relative L2 %.3g" % (part, err_jax)
        limit = F32_REL_L2 if part == "grads" else \
            max(PORT_F32_RATIO * err_jax, PORT_F32_FLOOR)
        assert err_port <= limit, "port fp32 %s %.3g from float64, JAX's " \
            "%.3g" % (part, err_port, err_jax)


def check_eval_forward(make_port, ref):
    """Inference-mode logits against the JAX net's, and the port's
    hybridized forward equal to its imperative one."""
    net = port_net(make_port, ref)
    rel = relative_names(list(net.collect_params().keys()), net.prefix)
    for n, p in net.collect_params().items():
        if rel[n] in ref["eval_stats"]:
            p.set_data(ref["eval_stats"][rel[n]])
    with mx.cpu(), mx.autograd.pause():
        imperative = net(mx.nd.array(ref["x"])).asnumpy()
        net.hybridize()
        hybrid = net(mx.nd.array(ref["x"])).asnumpy()
    _close(imperative, ref["eval_logits"], "inference-mode logits")
    np.testing.assert_allclose(hybrid, imperative, rtol=1e-6,
                               atol=1e-6 * np.abs(imperative).max())
