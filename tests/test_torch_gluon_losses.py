"""The port's gluon losses and the ``ctc_loss`` operator against the JAX
package's.

Every loss of the core surface's second half (SigmoidBinaryCrossEntropy
on logits and on probabilities, KLDiv, Huber, Hinge, SquaredHinge,
Logistic, Triplet, CTC) takes the same seeded numpy inputs and
``sample_weight`` in both packages: the per-sample loss and the
gradients of its weighted sum with respect to every float input agree
within rtol 1e-5 and atol 1e-6 * max|want| (fp32 in both), with the
port's loss hybridized and not.

``ctc_loss`` is held to the JAX op the same way at rtol 1e-5: both
layouts of ``CTCLoss``, both ``blank_label`` conventions, repeated
labels, ``pred_lengths`` below T, a label of length 0 and an alignment
that cannot exist, whose loss is the JAX package's finite 1e30 with a
zero gradient. The card's route (ATen's CTC with the blank and padding
translated) is held to the host's recursion here through ATen's CPU CTC,
and on the card by the ``cuda``-marked test.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import contrib_ops as jcontrib

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import contrib_ops as tcontrib
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-5, 1e-6


def _bce_prob(rng, shape):
    return rng.uniform(0.05, 0.95, shape).astype(np.float32)


# name: (class, kwargs, [input makers], sample_weight shape)
LOSSES = {
    "sigmoid_bce_logits": ("SigmoidBinaryCrossEntropyLoss", {},
                           ["pred", "binary"], (4, 1)),
    "sigmoid_bce_prob": ("SigmoidBCELoss", {"from_sigmoid": True},
                         ["prob", "binary"], (4, 1)),
    "kldiv_logits": ("KLDivLoss", {"from_logits": False},
                     ["pred", "dist"], (4, 1)),
    "kldiv_logp": ("KLDivLoss", {}, ["logp", "dist"], (4, 1)),
    "huber": ("HuberLoss", {"rho": 0.5}, ["pred", "pred"], (4, 1)),
    "hinge": ("HingeLoss", {"margin": 1.5}, ["pred", "signed"], (4, 1)),
    "squared_hinge": ("SquaredHingeLoss", {}, ["pred", "signed"], (4, 1)),
    "logistic_signed": ("LogisticLoss", {}, ["pred", "signed"], (4, 1)),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        ["pred", "binary"], (4, 1)),
    "triplet": ("TripletLoss", {"margin": 0.5}, ["pred", "pred", "pred"],
                (4,)),
}
SHAPE = (4, 6)


def _inputs(case, rng):
    out = []
    for kind in LOSSES[case][2]:
        if kind == "pred":
            out.append(rng.uniform(-2, 2, SHAPE).astype(np.float32))
        elif kind == "prob":
            out.append(_bce_prob(rng, SHAPE))
        elif kind == "binary":
            out.append(rng.randint(0, 2, SHAPE).astype(np.float32))
        elif kind == "signed":
            out.append(rng.randint(0, 2, SHAPE).astype(np.float32) * 2 - 1)
        elif kind == "dist":
            d = rng.uniform(0.1, 1, SHAPE).astype(np.float32)
            out.append(d / d.sum(axis=1, keepdims=True))
        elif kind == "logp":
            p = rng.uniform(-2, 2, SHAPE).astype(np.float32)
            out.append(p - np.log(np.exp(p).sum(axis=1, keepdims=True)))
    return out


def _run(fn, arrays, sample_weight, ns, wrt, between=()):
    """The loss and the gradients of its weighted sum; `sample_weight`
    is passed positionally after `between` (CTCLoss's lengths)."""
    nds = [ns.nd.array(a) for a in arrays]
    for i in wrt:
        nds[i].attach_grad()
    with ns.autograd.record():
        loss = fn(*nds, *between, ns.nd.array(sample_weight))
        total = (loss * ns.nd.array(np.arange(1, loss.shape[0] + 1,
                                              dtype=np.float32))).sum()
    total.backward()
    return loss.asnumpy(), [nds[i].grad.asnumpy() for i in wrt]


def _close(got, want, what, rtol=RTOL, atol_rel=ATOL_REL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max() + 1e-30,
                               err_msg=what)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_with_sample_weight_matches_jax(case, hybridize):
    cls, kwargs, kinds, sw_shape = LOSSES[case]
    rng = np.random.RandomState(sorted(LOSSES).index(case))
    arrays = _inputs(case, rng)
    sw = rng.uniform(0.5, 1.5, sw_shape).astype(np.float32)
    # Gradients with respect to every input that is not a label.
    wrt = [i for i, k in enumerate(kinds)
           if k in ("pred", "prob", "logp") or case == "triplet"]
    want, want_g = _run(getattr(jloss, cls)(**kwargs), arrays, sw, jmx, wrt)
    fn = getattr(tloss, cls)(**kwargs)
    fn.hybridize(hybridize)
    with mx.cpu():
        got, got_g = _run(fn, arrays, sw, mx, wrt)
    _close(got, want, "%s loss" % case)
    for i, g, w in zip(wrt, got_g, want_g):
        _close(g, w, "%s gradient of input %d" % (case, i))


@pytest.mark.parametrize("from_sigmoid", [False, True])
def test_sigmoid_bce_pos_weight_matches_jax(from_sigmoid):
    rng = np.random.RandomState(5)
    pred = rng.uniform(0.05, 0.95, SHAPE) if from_sigmoid else \
        rng.uniform(-3, 3, SHAPE)
    arrays = [pred.astype(np.float32),
              rng.randint(0, 2, SHAPE).astype(np.float32)]
    pos_weight = rng.uniform(0.5, 2, SHAPE).astype(np.float32)
    sw = rng.uniform(0.5, 1.5, (SHAPE[0], 1)).astype(np.float32)
    want, want_g = _run(jloss.SigmoidBCELoss(from_sigmoid=from_sigmoid),
                        arrays + [sw], pos_weight, jmx, [0])
    with mx.cpu():
        got, got_g = _run(tloss.SigmoidBCELoss(from_sigmoid=from_sigmoid),
                          arrays + [sw], pos_weight, mx, [0])
    _close(got, want, "loss")
    _close(got_g[0], want_g[0], "gradient")


def test_every_public_loss_of_the_jax_package_exists():
    assert set(jloss.__all__) <= set(tloss.__all__)
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss


def test_sigmoid_bce_is_stable_at_large_logits():
    """The stable form: finite at |x| = 80, where log(sigmoid) would
    underflow."""
    pred = np.array([[80.0, -80.0, 0.0]], np.float32)
    label = np.array([[0.0, 1.0, 1.0]], np.float32)
    with mx.cpu():
        got = tloss.SigmoidBCELoss()(mx.nd.array(pred),
                                     mx.nd.array(label)).asnumpy()
    np.testing.assert_allclose(got, [(80 + 80 + np.log(2)) / 3], rtol=1e-6)


# -- ctc_loss -------------------------------------------------------------

def _ctc_case(name):
    """(pred (T, N, C), label, pred_lengths, label_lengths, blank_label)."""
    rng = np.random.RandomState(len(name))
    if name == "last":
        label = np.array([[1, 2, 2, 0], [3, -1, -1, -1], [0, 1, 2, 3]],
                         np.float32)
        return rng.randn(9, 3, 5).astype(np.float32), label, None, None, \
            "last"
    if name == "first":
        label = np.array([[1, 1, 4], [2, 3, 0], [4, 0, 0]], np.float32)
        return rng.randn(7, 3, 5).astype(np.float32), label, None, None, \
            "first"
    if name == "pred_lengths":
        label = np.array([[1, 2, -1], [0, 0, 3], [2, -1, -1],
                          [3, 1, 0]], np.float32)
        lengths = np.array([8, 6, 3, 5], np.float32)
        return rng.randn(8, 4, 5).astype(np.float32), label, lengths, None, \
            "last"
    if name == "label_lengths":
        label = np.array([[1, 2, 0], [2, 2, 2], [0, 1, 1]], np.float32)
        lengths = np.array([2, 3, 1], np.float32)
        return rng.randn(8, 3, 5).astype(np.float32), label, None, lengths, \
            "last"
    if name == "empty_and_impossible":
        # Row 0 has no label; row 1 needs 1 + 1 + 1 + 1 (a blank between
        # the repeats) + 1 = 5 frames and has 4; row 2 needs 4 and has 4.
        label = np.array([[-1, -1, -1, -1], [1, 1, 2, 0], [2, 0, 1, 3]],
                         np.float32)
        return rng.randn(4, 3, 5).astype(np.float32), label, None, None, \
            "last"
    raise KeyError(name)


CTC_CASES = ["last", "first", "pred_lengths", "label_lengths",
             "empty_and_impossible"]


def _jax_ctc(pred, label, pl, ll, blank_label):
    weights = jnp.arange(1, pred.shape[1] + 1, dtype=jnp.float32)

    def total(p):
        loss = jcontrib.ctc_loss(
            p, jnp.asarray(label), None if pl is None else jnp.asarray(pl),
            None if ll is None else jnp.asarray(ll), blank_label=blank_label)
        return (loss * weights).sum(), loss

    (_, loss), grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(pred))
    return np.asarray(loss), np.asarray(grad)


def _port_ctc(pred, label, pl, ll, blank_label, ctx=None):
    ctx = ctx or mx.cpu()
    with ctx:
        p = mx.nd.array(pred)
        p.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.ctc_loss(
                p, mx.nd.array(label),
                None if pl is None else mx.nd.array(pl),
                None if ll is None else mx.nd.array(ll),
                blank_label=blank_label)
            total = (loss * mx.nd.array(np.arange(1, pred.shape[1] + 1,
                                                  dtype=np.float32))).sum()
        total.backward()
        return loss.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("name", CTC_CASES)
def test_ctc_loss_matches_jax(name):
    pred, label, pl, ll, blank = _ctc_case(name)
    want, want_g = _jax_ctc(pred, label, pl, ll, blank)
    got, got_g = _port_ctc(pred, label, pl, ll, blank)
    _close(got, want, "%s loss" % name)
    _close(got_g, want_g, "%s gradient" % name)


def test_ctc_impossible_alignment_is_the_jax_value_not_inf():
    pred, label, pl, ll, blank = _ctc_case("empty_and_impossible")
    want, want_g = _jax_ctc(pred, label, pl, ll, blank)
    got, got_g = _port_ctc(pred, label, pl, ll, blank)
    assert np.isfinite(got).all()
    assert got[1] == want[1] == np.float32(1e30)
    assert not got_g[:, 1].any() and not want_g[:, 1].any()
    # The empty label: every frame a blank.
    logp = torch.log_softmax(torch.from_numpy(pred), -1)
    np.testing.assert_allclose(got[0], -logp[:, 0, -1].sum().item(),
                               rtol=1e-6)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"), ("TNC", "TN"),
                                                 ("NTC", "TN"),
                                                 ("TNC", "NT")])
@pytest.mark.parametrize("hybridize", [False, True])
def test_ctc_loss_block_layouts_match_jax(layout, label_layout, hybridize):
    pred, label, _, _, _ = _ctc_case("last")          # (T, N, C), (N, L)
    sw = np.array([[0.5], [1.0], [2.0]], np.float32)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    want, want_g = _run(jloss.CTCLoss(layout, label_layout),
                        [pred, label], sw, jmx, [0], (None, None))
    fn = tloss.CTCLoss(layout, label_layout)
    fn.hybridize(hybridize)
    with mx.cpu():
        got, got_g = _run(fn, [pred, label], sw, mx, [0], (None, None))
    _close(got, want, "CTCLoss %s/%s" % (layout, label_layout))
    _close(got_g[0], want_g[0], "CTCLoss gradient")


def test_ctc_loss_is_registered_under_four_names():
    op = treg.get("ctc_loss")
    for name in ("CTCLoss", "_contrib_ctc_loss", "_contrib_CTCLoss"):
        assert treg.get(name) is op
    assert mx.nd.contrib.ctc_loss is not None


def _card_route_vs_plain(pred, label, pl, ll, blank_label, device):
    """The card route's translation (ATen's CTC on `device`) against the
    plain recursion on the host: losses and gradients."""
    outs = []
    for route, dev in ((tcontrib._ctc_plain, "cpu"),
                       (tcontrib._ctc_cuda, device)):
        p = torch.tensor(pred, device=dev, requires_grad=True)
        lab = torch.tensor(label, device=dev).long()
        C = pred.shape[2]
        if blank_label == "last":
            blank, valid, fill = C - 1, lab >= 0, 0
        else:
            blank, valid, fill = 0, lab > 0, 1
        lab = torch.where(valid, lab, torch.full_like(lab, fill))
        label_len = valid.sum(1) if ll is None else \
            torch.tensor(ll, device=dev).long()
        pred_len = torch.full((pred.shape[1],), pred.shape[0], device=dev) \
            if pl is None else torch.tensor(pl, device=dev).long()
        loss = route(torch.log_softmax(p, -1), lab, label_len, pred_len,
                     blank)
        (loss * torch.arange(1, len(loss) + 1, device=dev)).sum().backward()
        outs.append((loss.detach().cpu().numpy(), p.grad.cpu().numpy()))
    return outs


@pytest.mark.parametrize("name", CTC_CASES)
def test_ctc_card_route_translation_on_host(name):
    (want, want_g), (got, got_g) = _card_route_vs_plain(*_ctc_case(name),
                                                        "cpu")
    _close(got, want, "%s loss" % name)
    _close(got_g, want_g, "%s gradient" % name, rtol=1e-4, atol_rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CTC_CASES)
def test_ctc_card_route_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pred, label, pl, ll, blank = _ctc_case(name)
    (want, want_g), (got, got_g) = _card_route_vs_plain(
        pred, label, pl, ll, blank, "cuda")
    _close(got, want, "%s loss" % name)
    _close(got_g, want_g, "%s gradient" % name, rtol=1e-4, atol_rel=1e-5)
    # And through the registered op on a CUDA tensor.
    got_op, got_op_g = _port_ctc(pred, label, pl, ll, blank, mx.gpu(0))
    _close(got_op, want, "%s loss through the op" % name)
    _close(got_op_g, want_g, "%s gradient through the op" % name,
           rtol=1e-4, atol_rel=1e-5)
