"""Faster R-CNN and FlowNet operators.

Counterpart of ``mxnet_tpu/ops/rcnn_ops.py`` (reference:
src/operator/contrib/proposal.cc, contrib/multi_proposal.cc,
contrib/deformable_convolution.cc, contrib/deformable_psroi_pooling.cu,
src/operator/correlation.cc). The same 14 registry names and aliases.

- ``Proposal``/``MultiProposal``: anchors, box regression, the padding
  and min-size kills and the stable top-n sort in PyTorch, batched over
  images; greedy NMS with the legacy "+1" areas and the post-NMS quota
  is D1 (``detection_ops.nms_sorted``); the (post_nms_top_n, 5) output
  cycles through the kept rows (``keep[i % out_size]``, proposal.cc:414).
  Not differentiable, as in the reference.
- ``DeformableConvolution``: the deformable-im2col gather in PyTorch,
  contracted against the weight by ``torch.matmul`` (the JAX package
  leaves that product to XLA too).
- ``DeformablePSROIPooling``: one flat gather per bilinear corner.
  Scaled coordinates round half away from zero, as C's ``round`` in the
  reference; ``jnp.round`` rounds a half to even (ROADMAP Queue 3).
- ``Correlation``: the static displacement grid as shifted slices.

Gradients come from autograd wherever the JAX package differentiates.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import detection_ops
from .detection_ops import round_half_away
from .registry import register

__all__ = ["generate_anchors"]


def _tuple2(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


# ---------------------------------------------------------------------------
# anchor generation (legacy "+1" pixel conventions, proposal-inl.h:170-223)
# ---------------------------------------------------------------------------

def generate_anchors(base_size, ratios, scales):
    """(A, 4) base anchors; ratio-major, scale-minor enumeration to match
    GenerateAnchors (proposal-inl.h:214-223). Legacy width = x2-x1+1."""
    w = h = float(base_size)
    x_ctr = 0.5 * (w - 1.0)
    y_ctr = 0.5 * (h - 1.0)
    size = w * h
    out = []
    for ratio in ratios:
        size_ratio = math.floor(size / ratio)
        new_w = math.floor(math.sqrt(size_ratio) + 0.5)
        new_h = math.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw, sh = new_w * scale, new_h * scale
            out.append([x_ctr - 0.5 * (sw - 1.0), y_ctr - 0.5 * (sh - 1.0),
                        x_ctr + 0.5 * (sw - 1.0), y_ctr + 0.5 * (sh - 1.0)])
    return np.asarray(out, dtype=np.float32)


def _proposals(fg_scores, deltas, im_info, anchors, feature_stride,
               rpn_pre_nms_top_n, rpn_post_nms_top_n, threshold,
               rpn_min_size, iou_loss):
    """Proposals for a batch of images.

    fg_scores (B, A, H, W) foreground scores; deltas (B, 4A, H, W);
    im_info (B, 3) = (height, width, scale). Returns (rois (B, post, 4),
    scores (B, post)).
    """
    b, a_num, hh, ww = fg_scores.shape
    dev, dt = fg_scores.device, fg_scores.dtype
    # Every shifted anchor, h-major/w/a-minor like the reference's
    # workspace (index = h*W*A + w*A + a, proposal.cc:348).
    shift_x = torch.arange(ww, dtype=torch.float32, device=dev) * \
        feature_stride
    shift_y = torch.arange(hh, dtype=torch.float32, device=dev) * \
        feature_stride
    sx = shift_x[None, :, None].expand(hh, ww, a_num)
    sy = shift_y[:, None, None].expand(hh, ww, a_num)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    boxes = torch.as_tensor(anchors, device=dev)[None, None] + shifts
    boxes = boxes.to(dt)                                 # (H, W, A, 4)

    # Bbox regression (BBoxTransformInv, proposal.cc:46-96; legacy "+1"
    # width convention) or direct IoU offsets (IoUTransformInv).
    d = deltas.reshape(b, a_num, 4, hh, ww).permute(0, 3, 4, 1, 2)
    im_h, im_w, im_scale = [im_info[:, k, None, None, None]
                            for k in range(3)]
    if iou_loss:
        pred = boxes + d
    else:
        bw = boxes[..., 2] - boxes[..., 0] + 1.0
        bh = boxes[..., 3] - boxes[..., 1] + 1.0
        cx = boxes[..., 0] + 0.5 * (bw - 1.0)
        cy = boxes[..., 1] + 0.5 * (bh - 1.0)
        pcx = d[..., 0] * bw + cx
        pcy = d[..., 1] * bh + cy
        pw = torch.exp(d[..., 2]) * bw
        ph = torch.exp(d[..., 3]) * bh
        pred = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                            pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                           dim=-1)
    hi = torch.stack([im_w - 1.0, im_h - 1.0, im_w - 1.0, im_h - 1.0],
                     dim=-1)
    pred = torch.minimum(pred.clamp_min(0.0), hi)

    scores = fg_scores.permute(0, 2, 3, 1)               # (B, H, W, A)
    # Kill predictions from feature-map padding beyond the real image
    # extent (proposal.cc:362-366: h >= real_height -> score -1).
    real_h = torch.floor(im_h / feature_stride)
    real_w = torch.floor(im_w / feature_stride)
    yy = torch.arange(hh, dtype=torch.float32, device=dev)[:, None, None]
    xx = torch.arange(ww, dtype=torch.float32, device=dev)[None, :, None]
    minus1 = torch.full_like(scores, -1.0)
    scores = torch.where((yy >= real_h) | (xx >= real_w), minus1, scores)

    # FilterBox (proposal.cc:145-158): too-small boxes are inflated by
    # min_size/2 per side and score-killed.
    min_size = rpn_min_size * im_scale
    iw = pred[..., 2] - pred[..., 0] + 1.0
    ih = pred[..., 3] - pred[..., 1] + 1.0
    small = (iw < min_size) | (ih < min_size)
    half = torch.where(small, min_size / 2, torch.zeros_like(iw))
    pred = pred + torch.stack([-half, -half, half, half], dim=-1)
    scores = torch.where(small, minus1, scores)

    flat_boxes = pred.reshape(b, -1, 4)
    flat_scores = scores.reshape(b, -1)
    count = flat_scores.shape[1]
    n_pre = min(int(rpn_pre_nms_top_n), count)
    n_post = min(int(rpn_post_nms_top_n), n_pre)

    # Stable descending sort by score, keep top pre_nms.
    order = torch.sort(-flat_scores, dim=1, stable=True).indices[:, :n_pre]
    top_boxes = flat_boxes.gather(1, order[..., None].expand(-1, -1, 4))
    top_scores = flat_scores.gather(1, order)

    # Greedy NMS over the sorted list with the legacy "+1" areas; a box
    # is kept while the quota of post-NMS survivors is unfilled
    # (NonMaximumSuppression, proposal.cc:213-260).
    valid = torch.ones((b, n_pre), dtype=torch.bool, device=dev)
    _, kept_idx, n_kept = detection_ops.nms_sorted(
        top_boxes, valid, None, threshold, detection_ops.IOU_LEGACY, n_post)
    # Output rows cycle through the kept rows (proposal.cc:404-421:
    # keep[i % out_size]).
    out_size = n_kept.clamp_min(1)
    pos = torch.arange(int(rpn_post_nms_top_n), device=dev)
    sel = kept_idx.gather(1, pos[None, :] % out_size[:, None])
    return (top_boxes.gather(1, sel[..., None].expand(-1, -1, 4)),
            top_scores.gather(1, sel))


def _parse_floats(v, default):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return tuple(float(x) for x in v)
    return (float(v),)


def _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                   feature_stride=16, output_score=False, iou_loss=False):
    scales = _parse_floats(scales, (4.0, 8.0, 16.0, 32.0))
    ratios = _parse_floats(ratios, (0.5, 1.0, 2.0))
    anchors = generate_anchors(int(feature_stride), ratios, scales)
    a_num = anchors.shape[0]
    n_batch = cls_prob.shape[0]
    rois, scores = _proposals(
        cls_prob[:, a_num:], bbox_pred, im_info.to(cls_prob.dtype), anchors,
        float(feature_stride), int(rpn_pre_nms_top_n),
        int(rpn_post_nms_top_n), float(threshold), float(rpn_min_size),
        bool(iou_loss))
    post = rois.shape[1]
    batch_col = torch.arange(n_batch, dtype=rois.dtype, device=rois.device)
    batch_col = batch_col[:, None, None].expand(n_batch, post, 1)
    rois = torch.cat([batch_col, rois], dim=2).reshape(n_batch * post, 5)
    scores = scores.reshape(n_batch * post, 1)
    if output_score:
        return rois, scores
    return rois


@register("_contrib_Proposal", aliases=("Proposal", "_contrib_proposal"),
          differentiable=False)
def _proposal(cls_prob, bbox_pred, im_info, **kw):
    """RPN proposals (proposal.cc). cls_prob (N, 2A, H, W) — first A
    channels background, last A foreground; bbox_pred (N, 4A, H, W);
    im_info (N, 3) = (h, w, scale). Output (N*post_nms_top_n, 5) rows =
    (batch_idx, x1, y1, x2, y2)."""
    return _proposal_impl(cls_prob, bbox_pred, im_info, **kw)


@register("_contrib_MultiProposal",
          aliases=("MultiProposal", "_contrib_multi_proposal"),
          differentiable=False)
def _multi_proposal(cls_prob, bbox_pred, im_info, **kw):
    """Batched Proposal (multi_proposal.cc) — the same dataflow; every
    image produces its own post_nms_top_n block of rois."""
    return _proposal_impl(cls_prob, bbox_pred, im_info, **kw)


# ---------------------------------------------------------------------------
# deformable convolution (contrib/deformable_convolution.cc)
# ---------------------------------------------------------------------------

def _bilinear_sample(data, ys, xs):
    """Bilinear samples with the deformable-im2col border rule: a sample
    is 0 when its center is outside (-1, H) x (-1, W); corner taps outside
    the array contribute 0.

    data (N, G, Cg, H, W); ys/xs (N, G, K, OH, OW) -> (N, G, Cg, K, OH,
    OW)."""
    n, g, cg, h, w = data.shape
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    flat = data.reshape(n, g, cg, h * w)
    ni = torch.arange(n, device=data.device)[:, None, None, None]
    gi = torch.arange(g, device=data.device)[None, :, None, None]
    ci = torch.arange(cg, device=data.device)[None, None, :, None]
    pshape = ys.shape[2:]
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0 + dy
            xx = x0 + dx
            tap_ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yi = yy.clamp(0, h - 1).long()
            xi = xx.clamp(0, w - 1).long()
            pix = (yi * w + xi).reshape(n, g, 1, -1)
            vals = flat[ni, gi, ci, pix].reshape(n, g, cg, *pshape)
            out = out + vals * (wy * wx * tap_ok)[:, :, None]
    return out * valid[:, :, None]


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",
                   "_contrib_deformable_convolution"))
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=1, num_group=1,
                            num_deformable_group=1, no_bias=False,
                            workspace=1024, layout=None):
    """Deformable conv v1 (deformable_convolution.cc): each kernel tap
    samples at its regular position plus a learned per-position offset.
    offset (N, dg*2*kh*kw, OH, OW): within each deformable group, channel
    2*(i*kw+j) is the y-offset of tap (i, j), 2*(...)+1 the x-offset."""
    kh, kw = _tuple2(kernel)
    sh, sw = _tuple2(stride)
    dh, dw = _tuple2(dilate)
    ph, pw = _tuple2(pad)
    ng = int(num_group)
    dg = int(num_deformable_group)
    n, c, h, w = data.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw
    dt, dev = data.dtype, data.device

    # Regular grid positions per tap (K, OH, OW).
    oy = torch.arange(oh, dtype=dt, device=dev)[None, :, None] * sh - ph
    ox = torch.arange(ow, dtype=dt, device=dev)[None, None, :] * sw - pw
    ki = torch.arange(k, dtype=dt, device=dev)[:, None, None]
    base_y = oy + torch.div(ki, kw, rounding_mode="floor") * dh
    base_x = ox + torch.remainder(ki, kw) * dw

    off = offset.reshape(n, dg, k, 2, oh, ow)
    ys = base_y + off[:, :, :, 0]                        # (N, dg, K, OH, OW)
    xs = base_x + off[:, :, :, 1]
    sample = _bilinear_sample(data.reshape(n, dg, c // dg, h, w), ys, xs)
    sample = sample.reshape(n, c * k, oh * ow)           # (N, C*K, OH*OW)

    f = int(num_filter)
    wgt = weight.reshape(f, (c // ng) * k)
    cpg, fpg = (c // ng) * k, f // ng
    out = torch.cat([torch.matmul(wgt[g * fpg:(g + 1) * fpg],
                                  sample[:, g * cpg:(g + 1) * cpg])
                     for g in range(ng)], dim=1)
    out = out.reshape(n, f, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# deformable PS-ROI pooling (contrib/deformable_psroi_pooling.cu:71-161)
# ---------------------------------------------------------------------------

@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",
                   "_contrib_deformable_psroi_pooling"))
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False):
    """Position-sensitive ROI pooling with learned per-part offsets
    (deformable_psroi_pooling.cu:71-161). data (N, output_dim *
    group_size^2, H, W); rois (R, 5) = (batch_idx, x1, y1, x2, y2);
    trans (R, 2*ncls, part, part). Outputs (pooled (R, od, ps, ps),
    top_count), two outputs like the reference."""
    ps = int(pooled_size)
    gs = int(group_size)
    od = int(output_dim)
    spp = int(sample_per_part)
    part = int(part_size) or ps
    n, c, h, w = data.shape
    r = rois.shape[0]
    dev, dt = data.device, data.dtype
    no_trans = bool(no_trans) or trans is None
    rois = rois.to(dt)

    batch_ind = rois[:, 0].to(torch.int64)
    # round() + legacy 0.5-shift (deformable_psroi_pooling.cu:99-102).
    x1 = round_half_away(rois[:, 1]) * spatial_scale - 0.5
    y1 = round_half_away(rois[:, 2]) * spatial_scale - 0.5
    x2 = (round_half_away(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (round_half_away(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = (x2 - x1).clamp_min(0.1)                 # force min 1x1 rois
    roi_h = (y2 - y1).clamp_min(0.1)
    bin_w, bin_h = roi_w / ps, roi_h / ps
    sub_w, sub_h = bin_w / spp, bin_h / spp

    pidx = torch.arange(ps, device=dev)
    # Part cell and group cell of each pooled index (cu:115-116, 136-139).
    part_of = torch.floor(pidx.to(torch.float32) / ps * part).long()
    g_of = torch.div(pidx * gs, ps, rounding_mode="floor").clamp(0, gs - 1)

    # Learned offsets per (roi, output channel, bin): (R, od, ps, ps).
    if no_trans:
        tx = ty = torch.zeros((r, 1, 1, 1), dtype=dt, device=dev)
    else:
        ncls = trans.shape[1] // 2
        if od % ncls:
            # The reference's channels_each_class = od // ncls assumes
            # divisibility; a class past the end would take the wrong
            # class's offsets.
            raise ValueError(
                "DeformablePSROIPooling: output_dim (%d) must be a "
                "multiple of the trans class count (%d)" % (od, ncls))
        cls_of = torch.div(torch.arange(od, device=dev), max(od // ncls, 1),
                           rounding_mode="floor")
        # trans[r, 2*cls+{0,1}, part_h, part_w] (cu:118-125)
        tsel = trans[:, :, part_of][:, :, :, part_of]    # (R, 2ncls, ps, ps)
        tx = tsel[:, 0::2][:, cls_of] * float(trans_std)
        ty = tsel[:, 1::2][:, cls_of] * float(trans_std)

    # Sample coordinates (R, od|1, ps(h), ps(w), spp(h), spp(w)).
    ih = torch.arange(spp, dtype=dt, device=dev)
    pf = pidx.to(dt)
    hstart = y1[:, None, None, None] + \
        pf[None, None, :, None] * bin_h[:, None, None, None] + \
        ty * roi_h[:, None, None, None]
    wstart = x1[:, None, None, None] + \
        pf[None, None, None, :] * bin_w[:, None, None, None] + \
        tx * roi_w[:, None, None, None]
    hh = hstart[..., None, None] + \
        ih[:, None] * sub_h[:, None, None, None, None, None]
    ww = wstart[..., None, None] + \
        ih[None, :] * sub_w[:, None, None, None, None, None]
    hh, ww = torch.broadcast_tensors(hh, ww)

    # Samples with center outside [-0.5, dim-0.5] are skipped (cu:147 —
    # the borders themselves are inclusive).
    vmask = (hh >= -0.5) & (hh <= h - 0.5) & (ww >= -0.5) & (ww <= w - 0.5)
    hh = hh.clamp(0.0, h - 1.0)
    ww = ww.clamp(0.0, w - 1.0)

    # Position-sensitive channel c = (ctop*gs + gh)*gs + gw (cu:152).
    chan = (torch.arange(od, device=dev)[:, None, None] * gs
            + g_of[None, :, None]) * gs + g_of[None, None, :]  # (od, ps, ps)

    # One flat gather per bilinear corner over the whole batch buffer:
    # no per-roi copy of an image's feature map.
    dflat = data.reshape(n * c * h * w)
    noff = hh.shape[1]
    spp2 = spp * spp
    shape = (r, od, ps, ps, spp2)
    hh = hh.reshape(r, noff, ps, ps, spp2).expand(shape)
    ww = ww.reshape(r, noff, ps, ps, spp2).expand(shape)
    vm = vmask.reshape(r, noff, ps, ps, spp2).expand(shape)
    cbase = (batch_ind * (c * h * w))[:, None, None, None, None] \
        + (chan * (h * w))[None, :, :, :, None]
    h0 = torch.floor(hh)
    w0 = torch.floor(ww)
    ah, aw = hh - h0, ww - w0
    val = 0.0
    for dy, wy in ((0, 1.0 - ah), (1, ah)):
        for dx, wx in ((0, 1.0 - aw), (1, aw)):
            yi = (h0 + dy).clamp(0, h - 1).long()
            xi = (w0 + dx).clamp(0, w - 1).long()
            corner = dflat[cbase + yi * w + xi]
            val = val + corner * (wy * wx)
    val = val * vm
    cnt = vm.sum(dim=4).to(dt)                           # (R, od, ps, ps)
    pooled = torch.where(cnt > 0, val.sum(dim=4) / cnt.clamp_min(1.0),
                         torch.zeros_like(cnt))
    return pooled, cnt


# ---------------------------------------------------------------------------
# correlation (src/operator/correlation.cc)
# ---------------------------------------------------------------------------

@register("Correlation", aliases=("_contrib_Correlation",))
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation (correlation.cc:41-82): for every output
    position, correlate a k x k patch of data1 with patches of data2 at
    every displacement of a (2*max_disp/stride2+1)^2 grid, enumerated as
    shifted slices; each is a channel-summed product and a k x k window
    sum."""
    k = int(kernel_size)
    md = int(max_displacement)
    s1 = int(stride1)
    s2 = int(stride2)
    pad = int(pad_size)
    n, c, h, w = data1.shape
    ph_, pw_ = h + 2 * pad, w + 2 * pad
    kr = (k - 1) // 2
    border = md + kr
    top_h = int(math.ceil(float(ph_ - 2 * border) / s1))
    top_w = int(math.ceil(float(pw_ - 2 * border) / s1))
    assert top_h >= 1 and top_w >= 1, \
        "Correlation: neighborhood and kernel don't fit in the input"
    grid_r = md // s2
    grid_w = 2 * grid_r + 1

    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    # data2 gets an extra md halo so every displacement is a static slice.
    q = pad + md
    p2 = torch.nn.functional.pad(data2, (q, q, q, q))
    sumelems = float(k * k * c)
    y_end = md + (top_h - 1) * s1 + 1
    x_end = md + (top_w - 1) * s1 + 1
    chans = []
    for tc in range(grid_w * grid_w):
        s2o = (tc % grid_w - grid_r) * s2            # x displacement
        s2p = (tc // grid_w - grid_r) * s2           # y displacement
        q2 = p2[:, :, md + s2p:md + s2p + ph_, md + s2o:md + s2o + pw_]
        prod = p1 * q2 if is_multiply else (p1 - q2).abs()
        csum = prod.sum(dim=1)                       # (N, PH, PW)
        if k > 1:
            csum = csum.unfold(1, k, 1).unfold(2, k, 1).sum(dim=(-2, -1))
        # window top-left y1 = i*s1 + md; x1 = j*s1 + md
        chans.append(csum[:, md:y_end:s1, md:x_end:s1])
    return torch.stack(chans, dim=1) / sumelems
