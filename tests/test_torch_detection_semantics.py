"""Where the JAX package departs from the reference, the port's detection
ops give the reference's answer (ROADMAP Queue 3, "Faults of the JAX
package"); and the detection kernels against their plain versions.

- ROIPooling's gradient goes to one argmax per bin, the first in
  row-major order (reference roi_pooling.cc), where ``jnp.max``'s VJP
  splits it equally among tied maxima.
- ROIPooling and DeformablePSROIPooling round scaled coordinates half
  away from zero (C's ``round``), where ``jnp.round`` rounds half to
  even: at stride 16 an integer box edge of 8 scales to exactly 0.5.

The ``cuda``-marked tests run D1 (greedy NMS) and D2 (ROIPooling forward
and backward) on the card against their plain versions on the same CUDA
tensors: D1's keep masks and D2's forward bit for bit, D2's gradient
within D2_BWD_TOL (its atomics add a pixel's bins in no fixed order).
They skip without a card. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx  # noqa: F401  (registers the operators)
from mxnet_tpu_torch.ops import detection_ops as det
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

D2_BWD_TOL = (1e-5, 1e-6)     # rtol, atol as a share of max |want|


def test_round_half_away_is_cs_round():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 1.4,
                      -1.6, 3.0], dtype=torch.float32)
    want = [-3, -2, -1, 1, 2, 3, 0, 1, -2, 3]
    assert det.round_half_away(x).tolist() == want
    assert det.round_half_away(x.double()).tolist() == want


def test_roi_pooling_gradient_goes_to_the_first_tied_maximum():
    data = torch.zeros((1, 1, 4, 4), requires_grad=True)
    rois = torch.tensor([[0.0, 0.0, 0.0, 3.0, 3.0]])
    out = treg.get("ROIPooling").fn(data, rois, pooled_size=(2, 2),
                                    spatial_scale=1.0)
    out.backward(torch.tensor([[[[1.0, 2.0], [3.0, 4.0]]]]))
    want = torch.zeros((4, 4))
    # Each 2x2 bin's maxima all tie at 0: the reference routes the bin's
    # gradient to its first element in row-major order.
    want[0, 0], want[0, 2], want[2, 0], want[2, 2] = 1.0, 2.0, 3.0, 4.0
    assert torch.equal(data.grad[0, 0], want)


def test_roi_pooling_rounds_a_half_away_from_zero():
    # Box edges 8 and 56 at stride 16: 0.5 and 3.5 round to 1 and 4 (C's
    # round), not to 0 and 4 (half to even). Column 0 holds the largest
    # values, so a bin that took it in would show it.
    data = torch.arange(6.0).repeat(6, 1).flip(1).reshape(1, 1, 6, 6) \
        .contiguous()
    rois = torch.tensor([[0.0, 8.0, 8.0, 56.0, 56.0]])
    out, argmax = det.roi_pool_forward(data, rois, (1, 1), 1 / 16)
    assert out.item() == 4.0            # column 1: the window is x in [1, 4]
    assert argmax.item() == 1 * 6 + 1   # row 1, column 1
    # -40 and -8 scale to -2.5 and -0.5: C's round gives -3 and -1, a
    # window [-3, 0) that is empty on the map (0, argmax -1); half to even
    # would give -2 and 0, the window [-2, 1), which holds column 0.
    rois = torch.tensor([[0.0, -40.0, 8.0, -8.0, 56.0]])
    out, argmax = det.roi_pool_forward(data, rois, (1, 1), 1 / 16)
    assert out.item() == 0.0 and argmax.item() == -1


def test_deformable_psroi_pooling_rounds_a_half_away_from_zero():
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(1, 4, 10, 10).astype(np.float32))
    kw = dict(spatial_scale=0.5, output_dim=1, group_size=2, pooled_size=2,
              sample_per_part=2, no_trans=True)
    fn = treg.get("DeformablePSROIPooling").fn

    def pooled(box):
        return fn(data, torch.tensor([[0.0] + box]), **kw)[0]

    assert torch.equal(pooled([2.5, 1.5, 12.5, 14.5]),
                       pooled([3.0, 2.0, 13.0, 15.0]))
    assert not torch.equal(pooled([2.5, 1.5, 12.5, 14.5]),
                           pooled([2.0, 2.0, 12.0, 14.0]))


def test_nms_plain_version_honours_valid_quota_and_classes():
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.9],
                           [2.0, 2.0, 3.0, 3.0], [2.0, 2.0, 3.0, 2.9],
                           [5.0, 5.0, 6.0, 6.0]]])
    valid = torch.tensor([[True, True, False, True, True]])
    keep, kept, n = det.nms_sorted(boxes, valid, None, 0.5)
    # Box 2 is invalid: it neither survives nor suppresses box 3.
    assert keep.tolist() == [[True, False, False, True, True]]
    assert kept[0, :3].tolist() == [0, 3, 4] and n.tolist() == [3]
    keep, kept, n = det.nms_sorted(boxes, valid, None, 0.5, quota=2)
    assert keep.tolist() == [[True, False, False, True, False]]
    cls_ids = torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.0]])
    keep, _, _ = det.nms_sorted(boxes, valid, cls_ids, 0.5)
    assert keep.tolist() == [[True, True, False, True, True]]


def test_a_tensor_off_cpu_and_cuda_raises():
    boxes = torch.zeros((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        det.nms_sorted(boxes, torch.ones((1, 3), dtype=torch.bool,
                                         device="meta"), None, 0.5)


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_boxes(gen, dev, b, n, dtype, pixels):
    wh = torch.empty((b, n, 2), device=dev, dtype=dtype).uniform_(
        0.02, 0.3, generator=gen)
    xy = torch.rand((b, n, 2), device=dev, dtype=dtype, generator=gen) * \
        (1 - wh)
    return torch.cat([xy, xy + wh], -1) * pixels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,mode,quota,classes", [
    ((32, 400), det.IOU_CORNER, None, 20),
    ((2, 700), det.IOU_CORNER, None, 0),
    ((1, 6000), det.IOU_LEGACY, 300, 0),
    ((2, 1000), det.IOU_LEGACY, 2000, 0),
], ids=["ssd_decode", "force", "proposal", "quota_unfilled"])
def test_d1_equals_its_plain_version_bit_for_bit(dtype, shape, mode, quota,
                                                 classes):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n = shape
    boxes = _sorted_boxes(gen, dev, b, n, dtype,
                          1.0 if mode == det.IOU_CORNER else 600.0)
    valid = torch.rand((b, n), device=dev, generator=gen) < 0.9
    cls_ids = torch.randint(0, classes, (b, n), device=dev,
                            generator=gen).to(dtype) if classes else None
    before = det.NMS_LAUNCHES
    got = det.nms_sorted(boxes, valid, cls_ids, 0.45, mode, quota)
    assert det.NMS_LAUNCHES == before + 1
    want = det.nms_sorted_reference(boxes, valid, cls_ids, 0.45, mode,
                                    n if quota is None else quota)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_d2_equals_its_plain_version(dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    data = torch.randn((2, 64, 38, 63), device=dev, dtype=dtype,
                       generator=gen)
    wh = torch.empty((300, 2), device=dev, dtype=dtype).uniform_(
        16, 400, generator=gen)
    xy = torch.rand((300, 2), device=dev, dtype=dtype, generator=gen) * \
        (torch.tensor([1000.0, 600.0], device=dev, dtype=dtype) - wh)
    rois = torch.cat([torch.randint(0, 2, (300, 1), device=dev,
                                    generator=gen).to(dtype), xy, xy + wh], 1)
    out, am = det.roi_pool_forward(data, rois, (7, 7), 1 / 16)
    want, want_am = det.roi_pool_forward_reference(data, rois, (7, 7), 1 / 16)
    assert torch.equal(out, want) and torch.equal(am, want_am)
    grad = torch.rand(out.shape, device=dev, dtype=dtype, generator=gen)
    got = det.roi_pool_backward(grad, am, data.shape)
    want = det.roi_pool_backward_reference(grad, am, data.shape)
    rtol, atol_rel = D2_BWD_TOL
    atol = atol_rel * float(want.abs().max())
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.cuda
def test_d2_backward_is_refused_under_deterministic_algorithms():
    dev = _card()
    data = torch.randn((1, 4, 8, 8), device=dev, requires_grad=True)
    rois = torch.tensor([[0.0, 0.0, 0.0, 7.0, 7.0]], device=dev)
    out = treg.get("ROIPooling").fn(data, rois, pooled_size=(2, 2))
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            out.sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_a_cuda_tensor_of_another_dtype_raises():
    dev = _card()
    boxes = torch.zeros((1, 3, 4), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or float64"):
        det.nms_sorted(boxes, torch.ones((1, 3), dtype=torch.bool,
                                         device=dev), None, 0.5)
