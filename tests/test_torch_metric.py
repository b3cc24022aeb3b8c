"""Every registered metric of mxnet_tpu_torch against the JAX package's,
on the same numpy labels and predictions handed in as each package's
NDArrays (two updates, then ``get``). The metrics compute in numpy on
the host in both packages, so the values must be equal; the tolerance
(rtol 1e-12) only absorbs a sum taken in another order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

torch.set_num_threads(2)


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _classes(rng, n=10, k=4):
    return (rng.randint(0, k, n).astype(np.float32),
            _softmax(rng.randn(n, k)).astype(np.float32))


def _binary(rng, n=12):
    return (rng.randint(0, 2, n).astype(np.float32),
            _softmax(rng.randn(n, 2)).astype(np.float32))


def _regression(rng, n=9):
    return (rng.randn(n, 3).astype(np.float32),
            rng.randn(n, 3).astype(np.float32))


def _loss(rng, n=7):
    return (None, np.abs(rng.randn(n)).astype(np.float32))


CASES = {
    "acc": ({}, _classes),
    "accuracy": ({"axis": 1}, _classes),
    "topkaccuracy": ({"top_k": 2}, _classes),
    "top_k_acc": ({"top_k": 3}, _classes),
    "pearsoncorrelation": ({}, _regression),
    "crossentropy": ({"eps": 1e-8}, _classes),
    "negativeloglikelihood": ({}, _classes),
    "f1": ({}, _binary),
    "f1_micro": ({"average": "micro"}, _binary),
    "mcc": ({}, _binary),
    "mae": ({}, _regression),
    "mse": ({}, _regression),
    "rmse": ({}, _regression),
    "ce": ({}, _classes),
    "nll_loss": ({}, _classes),
    "perplexity": ({"ignore_label": 1}, _classes),
    "pearsonr": ({}, _regression),
    "loss": ({}, _loss),
    "torch": ({}, _loss),
    "caffe": ({}, _loss),
}


def _metric_name(case):
    return "f1" if case == "f1_micro" else case


def _feed(pkg, metric, label, pred):
    if label is None:
        metric.update(None, [pkg.nd.array(pred)])
    else:
        metric.update([pkg.nd.array(label)], [pkg.nd.array(pred)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    kw, make = CASES[case]
    jm = jmx.metric.create(_metric_name(case), **kw)
    tm = mx.metric.create(_metric_name(case), **kw)
    assert type(tm).__name__ == type(jm).__name__
    rng = np.random.RandomState(sorted(CASES).index(case))
    for _ in range(2):
        label, pred = make(rng)
        _feed(jmx, jm, label, pred)
        with mx.cpu():
            _feed(mx, tm, label, pred)
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    assert tm.get_config() == jm.get_config()
    tm.reset()
    assert np.isnan(tm.get()[1])


def test_composite_custom_and_np_metrics_match_jax():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(-1)).sum()), len(label)

    rng = np.random.RandomState(40)
    label, pred = _classes(rng)
    out = {}
    for pkg in (jmx, mx):
        comp = pkg.metric.create(["acc", "ce", feval])
        assert isinstance(comp, pkg.metric.CompositeEvalMetric)
        comp.add(pkg.metric.np(lambda l, p: float((p > 0.5).mean())))
        with (mx.cpu() if pkg is mx else _null()):
            comp.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
        out[pkg] = comp.get_name_value()
    assert [n for n, _ in out[mx]] == [n for n, _ in out[jmx]]
    np.testing.assert_allclose([v for _, v in out[mx]],
                               [v for _, v in out[jmx]], rtol=1e-12)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_metric_reads_bf16_and_card_free_arrays():
    """A bf16 NDArray is read through asnumpy (widened to float32), and a
    numpy array is taken as it is; the registry holds the JAX package's
    names."""
    rng = np.random.RandomState(41)
    label, pred = _classes(rng)
    m = mx.metric.Accuracy()
    with mx.cpu():
        m.update([mx.nd.array(label)], [mx.nd.array(pred, dtype="bfloat16")])
    m2 = mx.metric.Accuracy()
    m2.update([label], [pred])
    assert m.get() == m2.get()
    # Names of the classes each module defines (a test in the same
    # process may register more).
    own = [sorted(k for k in reg.keys() if reg.get(k).__module__ == mod)
           for reg, mod in ((mx.metric._REG, "mxnet_tpu_torch.metric"),
                            (jmx.metric._REG, "mxnet_tpu.metric"))]
    assert own[0] == own[1] and len(own[0]) > 15
