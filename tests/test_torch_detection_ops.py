"""The port's detection operators (``ops/detection_ops.py``, 19 names)
against the JAX package's.

The same seeded numpy inputs go through the JAX op on the CPU and the
port's op on host tensors (its plain versions, D1's and D2's included).
Discrete outputs (matches, keep masks, class targets, masks) must be
equal; values within RTOL and ATOL_REL * max|want| (fp32 in both:
the packages round some products and sums in another order). Gradients
of ROIPooling and ROIAlign are compared the same way.

ROIPooling's fixtures keep scaled coordinates off exact halves and its
maxima untied: there the port follows the reference and the JAX package
does not (``tests/test_torch_detection_semantics.py``). Their bin sizes
are dyadic (pooled sizes 2 and 4), so that no bin edge depends on
whether a product and a sum are fused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX operators)
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import detection_ops as det
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-5, 1e-6

DETECTION_NAMES = (
    "_contrib_MultiBoxPrior", "_contrib_multibox_prior", "MultiBoxPrior",
    "_contrib_bipartite_matching",
    "_contrib_MultiBoxTarget", "_contrib_multibox_target", "MultiBoxTarget",
    "_contrib_box_nms", "_contrib_box_non_maximum_suppression", "box_nms",
    "_contrib_box_iou", "box_iou",
    "_contrib_MultiBoxDetection", "_contrib_multibox_detection",
    "MultiBoxDetection",
    "ROIPooling", "roi_pooling", "_contrib_ROIAlign", "_contrib_roi_align")
RCNN_NAMES = (
    "_contrib_Proposal", "Proposal", "_contrib_proposal",
    "_contrib_MultiProposal", "MultiProposal", "_contrib_multi_proposal",
    "_contrib_DeformableConvolution", "DeformableConvolution",
    "_contrib_deformable_convolution",
    "_contrib_DeformablePSROIPooling", "DeformablePSROIPooling",
    "_contrib_deformable_psroi_pooling",
    "Correlation", "_contrib_Correlation")


def _jax(name, *arrays, **attrs):
    out = jreg.get(name).fn(*[None if a is None else jnp.asarray(a)
                              for a in arrays], **attrs)
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in outs]


def _port(name, *arrays, **attrs):
    out = treg.get(name).fn(*[None if a is None else torch.from_numpy(a)
                              for a in arrays], **attrs)
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach().numpy() for o in outs]


def _close(got, want, what, exact=False):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    atol = ATOL_REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _boxes(rng, shape, lo=0.05, hi=0.5):
    """Corner boxes in [0, 1]: random corners, sides in [lo, hi]."""
    wh = rng.uniform(lo, hi, shape + (2,))
    xy = rng.uniform(0, 1, shape + (2,)) * (1 - wh)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_every_name_is_registered_as_in_the_jax_package():
    for names in (DETECTION_NAMES, RCNN_NAMES):
        for name in names:
            jop, top = jreg.get(name), treg.get(name)
            assert top.name == jop.name, name
            assert top.differentiable == jop.differentiable, name
            assert set(top.aliases) == set(jop.aliases), name
    assert len(DETECTION_NAMES) == 19 and len(RCNN_NAMES) == 14


@pytest.mark.parametrize("name", ["_contrib_MultiBoxPrior", "MultiBoxPrior",
                                  "_contrib_multibox_prior"])
@pytest.mark.parametrize("attrs", [
    {"sizes": (0.3, 0.5), "ratios": (1, 2, 0.5), "clip": True},
    {"sizes": (0.2,), "ratios": (1.0,), "steps": (0.1, 0.2),
     "offsets": (0.3, 0.6)},
    {"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5, 3, 1 / 3),
     "steps": (8 / 300, 8 / 300)},
], ids=["clip", "steps_offsets", "ssd300_first_map"])
def test_multibox_prior_matches_jax(name, attrs):
    data = np.zeros((2, 3, 5, 6), np.float32)
    (want,), (got,) = _jax(name, data, **attrs), _port(name, data, **attrs)
    assert got.dtype == np.float32
    _close(got, want, name)


@pytest.mark.parametrize("shape,attrs", [
    ((6, 3), {"threshold": 0.3}),
    ((4, 6, 3), {"threshold": 0.3}),
    ((4, 6, 3), {"is_ascend": True, "threshold": 0.5}),
    ((3, 5, 7), {"threshold": 1e-12, "topk": 2}),
], ids=["2d", "batched", "ascend", "topk"])
def test_bipartite_matching_matches_jax(shape, attrs):
    dist = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = _jax("_contrib_bipartite_matching", dist, **attrs)
    got = _port("_contrib_bipartite_matching", dist, **attrs)
    for g, w in zip(got, want):
        _close(g, w, "bipartite_matching", exact=True)


def _target_inputs(rng, a=500, classes=3):
    """Anchors (1, A, 4); labels (3, 3, 5) with padding rows; cls_pred
    (3, C+1, A)."""
    anchors = _boxes(rng, (1, a), 0.05, 0.4)
    label = -np.ones((3, 3, 5), np.float32)
    label[0, :2, 1:] = _boxes(rng, (2,), 0.2, 0.5)
    label[0, :2, 0] = [1, 0]
    label[1, :3, 1:] = _boxes(rng, (3,), 0.1, 0.6)
    label[1, :3, 0] = [2, 2, 1]
    label[2, :1, 1:] = _boxes(rng, (1,), 0.3, 0.4)
    label[2, :1, 0] = [0]
    cls_pred = rng.rand(3, classes + 1, a).astype(np.float32)
    return anchors, label, cls_pred


@pytest.mark.parametrize("attrs", [
    {"overlap_threshold": 0.5},
    {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
     "negative_mining_thresh": 0.5, "minimum_negative_samples": 2},
    {"overlap_threshold": 0.3, "negative_mining_ratio": 2.0,
     "ignore_label": -2.0, "variances": (0.2, 0.2, 0.1, 0.1)},
], ids=["plain", "mining", "mining_other_params"])
def test_multibox_target_matches_jax(attrs):
    args = _target_inputs(np.random.RandomState(1))
    want = _jax("_contrib_MultiBoxTarget", *args, **attrs)
    got = _port("_contrib_MultiBoxTarget", *args, **attrs)
    names = ("box_target", "box_mask", "cls_target")
    for g, w, n in zip(got, want, names):
        _close(g, w, n, exact=n != "box_target")
    if "negative_mining_ratio" in attrs:
        assert (got[2] == attrs.get("ignore_label", -1.0)).any()


def _nms_data(rng, lead=(2,), n=60):
    """Rows [cls_id, score, x1, y1, x2, y2] with overlapping boxes."""
    d = np.zeros(lead + (n, 6), np.float32)
    d[..., 0] = rng.randint(0, 3, lead + (n,))
    d[..., 1] = rng.rand(*lead, n)
    d[..., 2:] = _boxes(rng, lead + (n,), 0.1, 0.5)
    return d


@pytest.mark.parametrize("attrs", [
    {"overlap_thresh": 0.3, "id_index": 0},
    {"overlap_thresh": 0.3, "id_index": 0, "topk": 25},
    {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True,
     "valid_thresh": 0.2},
    {"overlap_thresh": 0.5},
    {"overlap_thresh": 0.3, "topk": 0},
    {"overlap_thresh": 0.4, "in_format": "center", "out_format": "corner"},
    {"overlap_thresh": 0.4, "in_format": "corner", "out_format": "center",
     "id_index": 0},
], ids=["per_class", "topk", "force_suppress", "no_id", "topk0",
        "center_in", "center_out"])
def test_box_nms_matches_jax(attrs):
    d = _nms_data(np.random.RandomState(2))
    (want,), (got,) = (_jax("_contrib_box_nms", d, **attrs),
                       _port("_contrib_box_nms", d, **attrs))
    _close(got, want, "box_nms", exact=True)
    assert (got == -1).all(axis=-1).any() or attrs.get("topk") == 0 or \
        attrs["overlap_thresh"] >= 0.4


@pytest.mark.parametrize("lead", [(), (2, 3)], ids=["2d", "4d"])
def test_box_nms_other_ranks_match_jax(lead):
    d = _nms_data(np.random.RandomState(3), lead, 40)
    attrs = {"overlap_thresh": 0.3, "id_index": 0, "coord_start": 2,
             "score_index": 1}
    (want,), (got,) = (_jax("box_nms", d, **attrs),
                       _port("box_nms", d, **attrs))
    _close(got, want, "box_nms", exact=True)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rng = np.random.RandomState(4)
    lhs, rhs = _boxes(rng, (2, 5)), _boxes(rng, (7,))
    (want,), (got,) = (_jax("_contrib_box_iou", lhs, rhs, format=fmt),
                       _port("box_iou", lhs, rhs, format=fmt))
    _close(got, want, "box_iou")


def _detection_inputs(rng, a=960, classes=2, b=2):
    """The train_ssd example's anchor count (16x16 and 8x8 maps, 3 anchors
    a pixel): cls_prob (B, C+1, A), loc_pred (B, 4A), anchors (1, A, 4)."""
    logits = rng.randn(b, classes + 1, a) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return (prob.astype(np.float32),
            (rng.randn(b, a * 4) * 0.3).astype(np.float32),
            _boxes(rng, (1, a), 0.05, 0.4))


@pytest.mark.parametrize("attrs", [
    {"nms_threshold": 0.45, "threshold": 0.01},
    {"nms_threshold": 0.45, "threshold": 0.2, "nms_topk": 100},
    {"nms_threshold": 0.5, "threshold": 0.1, "force_suppress": True,
     "clip": False},
    {"nms_threshold": 0.3, "threshold": 0.1, "background_id": 1,
     "variances": (0.2, 0.2, 0.3, 0.3)},
], ids=["train_ssd", "topk", "force_noclip", "background1"])
def test_multibox_detection_matches_jax(attrs):
    args = _detection_inputs(np.random.RandomState(5))
    (want,), (got,) = (_jax("_contrib_MultiBoxDetection", *args, **attrs),
                       _port("MultiBoxDetection", *args, **attrs))
    kept = want[..., 0] >= 0
    np.testing.assert_array_equal(got[..., 0] >= 0, kept)
    _close(got, want, "MultiBoxDetection")
    assert kept.any() and not kept.all()


def _roi_inputs(rng):
    """Features (2, 3, 12, 14); ROIs whose coordinates scaled by 0.5 stay
    off exact halves, inside, across and outside the map."""
    data = rng.randn(2, 3, 12, 14).astype(np.float32)
    rois = np.array([[0, 1.3, 2.2, 20.7, 15.1], [1, 0.2, 0.4, 27.2, 23.4],
                     [0, 7.6, 3.1, 9.4, 4.2], [1, -3.4, -2.2, 30.2, 30.6],
                     [1, 12.3, 8.2, 12.4, 8.6]], np.float32)
    return data, rois


def _vjp_jax(name, data, rois, head, **attrs):
    fn = jreg.get(name).fn
    out, vjp = jax.vjp(lambda d: fn(d, jnp.asarray(rois), **attrs),
                       jnp.asarray(data))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(head))[0])


def _vjp_port(name, data, rois, head, **attrs):
    d = torch.from_numpy(data).requires_grad_(True)
    out = treg.get(name).fn(d, torch.from_numpy(rois), **attrs)
    out.backward(torch.from_numpy(head))
    return out.detach().numpy(), d.grad.numpy()


@pytest.mark.parametrize("name,attrs", [
    ("ROIPooling", {"pooled_size": (2, 4), "spatial_scale": 0.5}),
    ("roi_pooling", {"pooled_size": (4, 2), "spatial_scale": 0.5}),
    ("ROIPooling", {"pooled_size": (1, 1), "spatial_scale": 1.0}),
    ("_contrib_ROIAlign", {"pooled_size": (3, 3), "spatial_scale": 0.5,
                           "sample_ratio": 2}),
    ("_contrib_roi_align", {"pooled_size": (2, 4), "spatial_scale": 0.5,
                            "sample_ratio": 0}),
], ids=["roi_pool_2x4", "roi_pool_4x2", "roi_pool_1x1", "roi_align_s2",
        "roi_align_adaptive"])
def test_roi_ops_and_their_gradients_match_jax(name, attrs):
    rng = np.random.RandomState(6)
    data, rois = _roi_inputs(rng)
    if attrs["spatial_scale"] == 1.0:
        rois = np.round(rois) + 0.2     # off halves at scale 1 too
    out_shape = (len(rois), 3) + tuple(attrs["pooled_size"])
    head = rng.uniform(0.5, 1.5, out_shape).astype(np.float32)
    want, want_g = _vjp_jax(name, data, rois, head, **attrs)
    got, got_g = _vjp_port(name, data, rois, head, **attrs)
    _close(got, want, name)
    _close(got_g, want_g, name + " gradient")


def test_roi_pooling_plain_version_agrees_with_a_loop(monkeypatch):
    """D2's plain version (chunked, padded windows) against a loop over
    ROIs, channels and bins, chunk boundary crossed."""
    rng = np.random.RandomState(7)
    data = torch.from_numpy(rng.randn(2, 4, 9, 11).astype(np.float32))
    rois = torch.from_numpy(np.concatenate([
        rng.randint(0, 2, (37, 1)), rng.uniform(-2, 12, (37, 4))],
        1).astype(np.float32))
    monkeypatch.setattr(det, "_ROI_POOL_CHUNK", 5)
    out, argmax = det.roi_pool_forward_reference(data, rois, (3, 2), 1.0)
    assert argmax.dtype == torch.int32
    for r in range(37):
        b = int(rois[r, 0])
        f = np.float32      # every product and sum rounded in fp32
        x1, y1, x2, y2 = [f(det.round_half_away(rois[r, k]))
                          for k in range(1, 5)]
        bh = max(y2 - y1 + f(1), f(1)) / f(3)
        bw = max(x2 - x1 + f(1), f(1)) / f(2)
        for i in range(3):
            for j in range(2):
                ys = range(max(int(np.floor(y1 + f(i) * bh)), 0),
                           min(int(np.ceil(y1 + f(i + 1) * bh)), 9))
                xs = range(max(int(np.floor(x1 + f(j) * bw)), 0),
                           min(int(np.ceil(x1 + f(j + 1) * bw)), 11))
                for c in range(4):
                    win = [(float(data[b, c, y, x]), ((b * 4 + c) * 9 + y)
                            * 11 + x) for y in ys for x in xs]
                    if not win:
                        assert out[r, c, i, j] == 0
                        assert argmax[r, c, i, j] == -1
                        continue
                    best = max(win, key=lambda t: t[0])
                    assert out[r, c, i, j] == best[0]
                    assert argmax[r, c, i, j] == best[1]


@pytest.mark.parametrize("short", ["MultiBoxPrior", "MultiBoxTarget",
                                   "MultiBoxDetection", "box_nms", "box_iou",
                                   "bipartite_matching", "ROIAlign",
                                   "Proposal", "MultiProposal",
                                   "DeformableConvolution",
                                   "DeformablePSROIPooling"])
def test_contrib_namespaces_reach_the_names_as_in_the_jax_package(short):
    """nd.contrib.<name> and sym.contrib.<name> resolve in both packages
    to the same operator; a composed symbol has the JAX package's output
    count and arguments (its symbol.py gives these ops no rule: one
    visible output, no auto-created weight)."""
    import mxnet_tpu as jmx

    assert callable(getattr(mx.nd.contrib, short))
    assert callable(getattr(jmx.nd.contrib, short))
    args = {"MultiBoxPrior": 1, "box_nms": 1, "bipartite_matching": 1,
            "ROIAlign": 2, "box_iou": 2, "DeformablePSROIPooling": 2,
            "DeformableConvolution": 2}.get(short, 3)
    kw = {"MultiBoxPrior": {"sizes": (0.5,)},
          "DeformableConvolution": {"kernel": (3, 3), "num_filter": 2,
                                    "no_bias": True},
          "Proposal": {"output_score": True},
          "MultiProposal": {"output_score": True}}.get(short, {})
    got, want = [], []
    for pkg, out in ((mx, got), (jmx, want)):
        syms = [pkg.sym.var("v%d" % i) for i in range(args)]
        s = getattr(pkg.sym.contrib, short)(*syms, **kw)
        out.append((len(s.list_outputs()), s.list_arguments()))
    assert got == want
