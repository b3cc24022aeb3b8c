"""The port's Faster R-CNN and FlowNet operators (``ops/rcnn_ops.py``,
14 names) against the JAX package's.

The same seeded numpy inputs go through the JAX op on the CPU and the
port's op on host tensors (D1's plain version inside Proposal). ROIs and
scores within RTOL and ATOL_REL * max|want| (fp32 in both); the rows
Proposal keeps, and its output's batch column, equal. Gradients (the
deformable ops, Correlation) are compared the same way.
DeformablePSROIPooling's fixtures hold no exact half before rounding:
there the port rounds as the reference does and the JAX package does not
(``tests/test_torch_detection_semantics.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX operators)
from mxnet_tpu.ops import rcnn_ops as jrcnn
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx  # noqa: F401
from mxnet_tpu_torch.ops import rcnn_ops as trcnn
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-5, 1e-6


def _close(got, want, what, rtol=RTOL, atol_rel=ATOL_REL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _vjp(name, arrays, wrt, head, **attrs):
    """(outputs, gradients of <outputs[0], head> w.r.t. arrays[wrt]) in
    the JAX package and in the port."""
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn

    def jf(*diff):
        args = list(map(jnp.asarray, arrays))
        for i, d in zip(wrt, diff):
            args[i] = d
        out = jfn(*args, **attrs)
        return out[0] if isinstance(out, tuple) else out

    out, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in wrt])
    want = (np.asarray(out), [np.asarray(g)
                              for g in vjp(jnp.asarray(head))])
    targs = [torch.from_numpy(a) for a in arrays]
    for i in wrt:
        targs[i].requires_grad_(True)
    tout = tfn(*targs, **attrs)
    tout = tout[0] if isinstance(tout, tuple) else tout
    tout.backward(torch.from_numpy(head))
    got = (tout.detach().numpy(), [targs[i].grad.numpy() for i in wrt])
    return got, want


def test_generate_anchors_matches_jax():
    for args in ((16, (0.5, 1.0, 2.0), (8.0, 16.0, 32.0)),
                 (8, (1.0,), (2.0, 4.0))):
        np.testing.assert_array_equal(trcnn.generate_anchors(*args),
                                      jrcnn._generate_anchors(*args))


def _rpn_inputs(rng, b, a, h, w, im_info):
    return (rng.rand(b, 2 * a, h, w).astype(np.float32),
            (rng.randn(b, 4 * a, h, w) * 0.3).astype(np.float32),
            np.asarray(im_info, np.float32))


# The image smaller than the map at its stride kills padding rows and
# columns; rpn_min_size 4-8 kills small boxes; post_nms_top_n above the
# survivors leaves the quota unfilled, so the output cycles.
PROPOSAL_CASES = {
    "padding_kills": (1, 3, 6, 7, [[44.0, 52.0, 1.0]],
                      dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12,
                           threshold=0.7, rpn_min_size=4,
                           scales=(2.0, 4.0, 8.0), ratios=(1.0,),
                           feature_stride=8)),
    "quota_unfilled": (1, 3, 6, 7, [[48.0, 56.0, 1.5]],
                       dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=50,
                            threshold=0.3, rpn_min_size=8,
                            scales=(2.0, 4.0, 8.0), ratios=(1.0,),
                            feature_stride=8)),
    "ratios_defaults": (1, 12, 5, 6, [[80.0, 96.0, 1.0]],
                        dict(rpn_pre_nms_top_n=300, rpn_post_nms_top_n=30,
                             feature_stride=16)),
    "iou_loss": (1, 2, 5, 5, [[70.0, 70.0, 1.0]],
                 dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8,
                      scales=(4.0, 8.0), ratios=(1.0,), iou_loss=True)),
}


@pytest.mark.parametrize("name", ["_contrib_Proposal", "Proposal",
                                  "_contrib_proposal"])
@pytest.mark.parametrize("case", sorted(PROPOSAL_CASES))
def test_proposal_matches_jax(name, case):
    b, a, h, w, im_info, attrs = PROPOSAL_CASES[case]
    args = _rpn_inputs(np.random.RandomState(7), b, a, h, w, im_info)
    want = [np.asarray(o) for o in jreg.get(name).fn(
        *map(jnp.asarray, args), output_score=True, **attrs)]
    got = [o.numpy() for o in treg.get(name).fn(
        *map(torch.from_numpy, args), output_score=True, **attrs)]
    _close(got[0], want[0], "rois", atol_rel=1e-6)
    _close(got[1], want[1], "scores")
    # The same rows, in the same order: each row's score is an input's.
    np.testing.assert_array_equal(got[1], want[1])
    if case == "quota_unfilled":
        rows = got[0][:, 1:]
        assert len(np.unique(rows, axis=0)) < len(rows)   # it cycled


@pytest.mark.parametrize("name", ["_contrib_MultiProposal", "MultiProposal",
                                  "_contrib_multi_proposal"])
def test_multi_proposal_matches_jax(name):
    args = _rpn_inputs(np.random.RandomState(3), 2, 2, 5, 5,
                       [[70.0, 70.0, 1.0], [60.0, 76.0, 1.2]])
    attrs = dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8, threshold=0.6,
                 rpn_min_size=8, scales=(4.0, 8.0), ratios=(1.0,),
                 feature_stride=16)
    (want,) = [np.asarray(jreg.get(name).fn(*map(jnp.asarray, args),
                                            **attrs))]
    got = treg.get(name).fn(*map(torch.from_numpy, args), **attrs).numpy()
    assert got.shape == (16, 5)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    _close(got, want, "rois")


DEFORM_CASES = {
    # (data, offset channels, weight, attrs)
    "zero_offset": ((2, 4, 9, 9), "zero", (6, 4, 3, 3),
                    dict(kernel=(3, 3), num_filter=6)),
    "integer_offset": ((1, 2, 8, 8), "integer", (3, 2, 3, 3),
                       dict(kernel=(3, 3), num_filter=3, no_bias=True)),
    "groups": ((2, 4, 9, 9), "random", (6, 2, 3, 3),
               dict(kernel=(3, 3), num_filter=6, num_group=2,
                    num_deformable_group=2)),
    "stride_pad_dilate": ((1, 4, 11, 10), "random", (5, 4, 3, 3),
                          dict(kernel=(3, 3), stride=(2, 2), pad=(2, 1),
                               dilate=(2, 1), num_filter=5)),
}


def _deform_inputs(case, rng):
    dshape, kind, wshape, attrs = DEFORM_CASES[case]
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    ph, pw = attrs.get("pad", (0, 0))
    dh, dw = attrs.get("dilate", (1, 1))
    oh = (dshape[2] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (dshape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = attrs.get("num_deformable_group", 1)
    oshape = (dshape[0], dg * 2 * kh * kw, oh, ow)
    if kind == "zero":
        off = np.zeros(oshape, np.float32)
    elif kind == "integer":
        off = np.zeros(oshape, np.float32)
        off[:, 1::2] = 1.0
    else:
        # Away from integer sampling points: no bilinear kink within
        # rounding of a sample.
        off = (rng.randint(-2, 2, oshape) + rng.uniform(0.1, 0.9, oshape)
               ).astype(np.float32)
    x = rng.randn(*dshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.3).astype(np.float32)
    b = rng.randn(wshape[0]).astype(np.float32)
    return [x, off, w, b], attrs


@pytest.mark.parametrize("case", sorted(DEFORM_CASES))
def test_deformable_convolution_and_gradient_match_jax(case):
    rng = np.random.RandomState(9)
    arrays, attrs = _deform_inputs(case, rng)
    out = treg.get("DeformableConvolution").fn(
        *map(torch.from_numpy, arrays), **attrs)
    head = rng.uniform(0.5, 1.5, out.shape).astype(np.float32)
    wrt = [0, 2] if case in ("zero_offset", "integer_offset") else [0, 1, 2, 3]
    (got, got_g), (want, want_g) = _vjp("_contrib_DeformableConvolution",
                                        arrays, wrt, head, **attrs)
    _close(got, want, case)
    for i, g, w in zip(wrt, got_g, want_g):
        _close(g, w, "%s gradient %d" % (case, i), rtol=1e-4, atol_rel=1e-5)


def test_deformable_convolution_with_zero_offset_is_the_convolution():
    arrays, attrs = _deform_inputs("zero_offset", np.random.RandomState(5))
    got = treg.get("_contrib_deformable_convolution").fn(
        *map(torch.from_numpy, arrays), **attrs)
    want = torch.nn.functional.conv2d(*map(torch.from_numpy, [arrays[0]] +
                                           arrays[2:]))
    _close(got.numpy(), want.numpy(), "deformable conv at zero offset",
           rtol=1e-4, atol_rel=1e-5)


def _psroi_inputs(rng):
    od, gs, ps, part, spp = 3, 2, 4, 4, 2
    data = rng.randn(2, od * gs * gs, 10, 10).astype(np.float32)
    rois = np.array([[0, 2.2, 2.3, 7.1, 8.4], [1, 0, 1, 9, 9],
                     [0, 4.3, 3.8, 5.2, 5.1]], np.float32)
    trans = (rng.rand(3, 2, part, part).astype(np.float32) - 0.5)
    attrs = dict(spatial_scale=0.8, output_dim=od, group_size=gs,
                 pooled_size=ps, part_size=part, sample_per_part=spp,
                 trans_std=0.3)
    return data, rois, trans, attrs


@pytest.mark.parametrize("name", ["_contrib_DeformablePSROIPooling",
                                  "DeformablePSROIPooling",
                                  "_contrib_deformable_psroi_pooling"])
@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pooling_matches_jax(name, with_trans):
    rng = np.random.RandomState(13)
    data, rois, trans, attrs = _psroi_inputs(rng)
    arrays = [data, rois] + ([trans] if with_trans else [])
    if not with_trans:
        attrs["no_trans"] = True
    want = [np.asarray(o) for o in jreg.get(name).fn(
        *map(jnp.asarray, arrays), **attrs)]
    got = [o.numpy() for o in treg.get(name).fn(
        *map(torch.from_numpy, arrays), **attrs)]
    np.testing.assert_array_equal(got[1], want[1])   # sample counts
    _close(got[0], want[0], name)


def test_deformable_psroi_pooling_gradient_matches_jax():
    rng = np.random.RandomState(14)
    data, rois, trans, attrs = _psroi_inputs(rng)
    head = rng.uniform(0.5, 1.5, (3, 3, 4, 4)).astype(np.float32)
    (got, got_g), (want, want_g) = _vjp(
        "_contrib_DeformablePSROIPooling", [data, rois, trans], [0, 2],
        head, **attrs)
    _close(got, want, "psroi")
    for g, w, what in zip(got_g, want_g, ("data", "trans")):
        _close(g, w, "psroi gradient " + what, rtol=1e-4, atol_rel=1e-5)


# The JAX package's own grid (tests/test_rcnn.py:184-190).
@pytest.mark.parametrize("k,md,s1,s2,pad,mult", [
    (1, 2, 1, 1, 2, True),
    (1, 2, 1, 2, 2, True),
    (3, 2, 2, 1, 3, True),
    (1, 1, 1, 1, 1, False),
])
@pytest.mark.parametrize("name", ["Correlation", "_contrib_Correlation"])
def test_correlation_and_gradient_match_jax(name, k, md, s1, s2, pad, mult):
    rng = np.random.RandomState(11)
    arrays = [rng.randn(2, 3, 8, 9).astype(np.float32) for _ in range(2)]
    attrs = dict(kernel_size=k, max_displacement=md, stride1=s1, stride2=s2,
                 pad_size=pad, is_multiply=mult)
    out = treg.get(name).fn(*map(torch.from_numpy, arrays), **attrs)
    head = rng.uniform(0.5, 1.5, out.shape).astype(np.float32)
    (got, got_g), (want, want_g) = _vjp(name, arrays, [0, 1], head, **attrs)
    _close(got, want, name)
    for g, w in zip(got_g, want_g):
        _close(g, w, name + " gradient", rtol=1e-4, atol_rel=1e-5)
