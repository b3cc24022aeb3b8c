"""Detection and bounding-box operators (SSD and R-CNN families).

Counterpart of ``mxnet_tpu/ops/detection_ops.py`` (reference:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc, src/operator/roi_pooling.cc,
contrib/roi_align.cc). The same 19 registry names, aliases and
``differentiable=False`` flags. Boxes are corner-format (xmin, ymin,
xmax, ymax); suppressed and invalid slots hold -1, as in the reference.

Two kernels of ``csrc/detection.cu`` serve this module and
``rcnn_ops``; each has a plain PyTorch version beside it, which a CPU
tensor runs. A CUDA tensor always reaches the kernel, or the call
raises: nothing falls back to the plain versions.

- D1, greedy non-maximum suppression (:func:`nms_sorted`): a mask
  kernel sets, for each pair of score-sorted boxes i < j, whether i
  would suppress j; a scan kernel walks the boxes in order once per
  image. The JAX package runs a ``lax.fori_loop`` of one trip per box
  over an n x n IoU matrix (``_nms_mask``); the port cuts to the top
  ``topk`` first (a box past it can never suppress), so SSD's
  ``nms_topk=400`` builds a 400-box mask, not an 8 732-box one.
- D2, ``ROIPooling`` forward and backward (:func:`roi_pool_forward`,
  :func:`roi_pool_backward`): the max and first argmax of each bin, and
  the gradient added at the argmax. The JAX package masks a
  (C, ph, pw, H, W) array per ROI.

Where the JAX package departs from the reference, the port follows the
reference (ROADMAP Queue 3, "Faults of the JAX package"): ``ROIPooling``
rounds scaled coordinates half away from zero (C's ``round``), where
``jnp.round`` rounds half to even, and its gradient goes to one argmax
per bin, the first in row-major order, where ``jnp.max``'s VJP splits
it among tied maxima.

Everything else is PyTorch: matching is a loop of min(anchors, labels)
rounds batched over images, ``ROIAlign`` a gather of its bilinear
samples whose gradient autograd takes.
"""
from __future__ import annotations

import ctypes
import functools
import warnings

import numpy as np
import torch

from .. import _native
from .registry import register

__all__ = ["nms_sorted", "nms_sorted_reference", "nms_keep",
           "roi_pool_forward", "roi_pool_backward",
           "roi_pool_forward_reference", "roi_pool_backward_reference",
           "round_half_away", "IOU_CORNER", "IOU_LEGACY",
           "NMS_LAUNCHES", "ROI_POOL_LAUNCHES", "ROI_POOL_BWD_LAUNCHES"]

# Kernel launches since import, each counted where its kernel is
# launched and nowhere else: D1 (one count is the mask kernel and the
# scan kernel of one call), D2's forward and D2's backward.
NMS_LAUNCHES = 0
ROI_POOL_LAUNCHES = 0
ROI_POOL_BWD_LAUNCHES = 0

# D1's IoU formulas: _pairwise_iou's, and Proposal's legacy "+1" areas.
IOU_CORNER = 0
IOU_LEGACY = 1

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# ROIs gathered at a time by D2's plain forward.
_ROI_POOL_CHUNK = 16
# D2's argmax is an int32 flat index into the feature map.
_ROI_POOL_MAX_ELEMENTS = 2 ** 31


def _pairwise_iou(a, b):
    """IoU matrix between corner boxes a (..., N, 4) and b (..., M, 4),
    in the JAX function's order of operations."""
    ax1, ay1, ax2, ay2 = [a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [b[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
    area_b = (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _legacy_iou(a, b):
    """Proposal's IoU with "+1" pixel areas (rcnn_ops.py:153-165), a
    (..., N, 4) against b (..., M, 4)."""
    ax1, ay1, ax2, ay2 = [a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [b[..., None, :, i] for i in range(4)]
    inter = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0) \
        .clamp_min(0) * \
        (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0).clamp_min(0)
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / (area_a + area_b - inter)


def round_half_away(x):
    """C's ``round``: a half rounds away from zero (torch.round, like
    jnp.round, rounds it to even)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x),
                       torch.round(x))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_kernel_dtype(name, *tensors):
    t = tensors[0]
    if t.dtype not in _DTYPE_CODE:
        raise ValueError("%s kernel takes float32 or float64, got %s"
                         % (name, t.dtype))
    if any(x.dtype != t.dtype for x in tensors):
        raise ValueError("%s kernel: inputs must share a dtype" % name)
    if any(x.device != t.device for x in tensors):
        raise ValueError("%s kernel: inputs must share a device" % name)


def _route(name, t):
    """True for the plain version (a CPU tensor), False for the kernel
    (a CUDA tensor); raise on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("%s runs on CPU or CUDA tensors, got %s"
                         % (name, t.device))
    return False


def _raise_on(name, err):
    if err:
        raise RuntimeError("%s kernel launch failed (cudaError %d)"
                           % (name, err))


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _native.load("detection")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nms_mask.argtypes = [P, P, I, I, I, I, ctypes.c_double, I, P, P]
    lib.nms_scan.argtypes = [P, P, I, I, I, I, P, P, P, P]
    lib.roi_pool_fwd.argtypes = [P, P, I] + [I] * 7 + \
        [ctypes.c_double, P, P, P]
    lib.roi_pool_bwd.argtypes = [P, P, I, ctypes.c_longlong, P, P]
    for fn in (lib.nms_mask, lib.nms_scan, lib.roi_pool_fwd,
               lib.roi_pool_bwd):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# D1: greedy NMS over score-sorted boxes
# ---------------------------------------------------------------------------

def _kill_matrix(boxes, cls_ids, thresh, iou_mode):
    """(B, n, n) bool: box i suppresses box j (j > i, the pair may
    suppress, IoU above `thresh`), as the mask kernel sets its bits."""
    iou = _pairwise_iou(boxes, boxes) if iou_mode == IOU_CORNER \
        else _legacy_iou(boxes, boxes)
    n = boxes.shape[1]
    kill = (iou > thresh) & torch.ones(n, n, dtype=torch.bool,
                                       device=boxes.device).triu(1)
    if cls_ids is not None:
        kill &= cls_ids[:, :, None] == cls_ids[:, None, :]
    return kill


def _kept_positions(keep, n_kept):
    """The kept positions of each row in order, 0 past the row's count."""
    n = keep.shape[1]
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    pos = torch.arange(n, device=keep.device)
    return torch.where(pos[None, :] < n_kept[:, None], order,
                       torch.zeros_like(order))


def nms_sorted_reference(boxes, valid, cls_ids, thresh, iou_mode, quota):
    """Plain PyTorch version of D1 (see :func:`nms_sorted`): the kill
    matrix in torch, then a loop over the boxes in order."""
    b, n = valid.shape
    kill = _kill_matrix(boxes, cls_ids, thresh, iou_mode)
    removed = ~valid
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    n_kept = torch.zeros((b,), dtype=torch.int64, device=boxes.device)
    for i in range(n):
        take = ~removed[:, i] & (n_kept < quota)
        keep[:, i] = take
        n_kept += take
        removed = removed | (take[:, None] & kill[:, i])
    return keep, _kept_positions(keep, n_kept), n_kept


def nms_sorted(boxes, valid, cls_ids, thresh, iou_mode=IOU_CORNER,
               quota=None):
    """Greedy NMS over boxes already sorted by descending score.

    boxes (B, n, 4) corners; valid (B, n) bool (an invalid box is never
    kept and never suppresses); cls_ids (B, n), or None where every pair
    may suppress (``force_suppress``); a kept box suppresses every later
    box of its class whose IoU (`iou_mode`) exceeds `thresh`; the walk
    stops after `quota` kept boxes (None: no quota). Returns (keep (B, n)
    bool, kept positions in order (B, n) int64, 0 past the count, the
    count (B,) int64). CPU tensors run :func:`nms_sorted_reference`;
    CUDA tensors launch D1 (float32 or float64).
    """
    global NMS_LAUNCHES
    b, n = valid.shape
    quota = n if quota is None else int(quota)
    if _route("nms", boxes):
        return nms_sorted_reference(boxes, valid, cls_ids, thresh, iou_mode,
                                    quota)
    dev = boxes.device
    keep = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    kept_idx = torch.zeros((b, n), dtype=torch.int64, device=dev)
    n_kept = torch.zeros((b,), dtype=torch.int64, device=dev)
    if b == 0 or n == 0:
        return keep.bool(), kept_idx, n_kept
    boxes = boxes.contiguous()
    tensors = (boxes,) if cls_ids is None else (boxes, cls_ids)
    _check_kernel_dtype("nms", *tensors)
    if boxes.shape != (b, n, 4) or valid.device != dev or (
            cls_ids is not None and cls_ids.shape != (b, n)):
        raise ValueError("nms kernel: boxes (B, n, 4), valid and class ids "
                         "(B, n) on one device, got %s, %s on %s, %s"
                         % (tuple(boxes.shape), tuple(valid.shape),
                            valid.device, None if cls_ids is None
                            else tuple(cls_ids.shape)))
    if cls_ids is not None:
        cls_ids = cls_ids.contiguous()
    valid = valid.to(torch.uint8).contiguous()
    words = (n + 63) // 64
    mask = torch.empty((b, n, words), dtype=torch.int64, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        _raise_on("nms_mask", lib.nms_mask(
            boxes.data_ptr(), None if cls_ids is None else cls_ids.data_ptr(),
            _DTYPE_CODE[boxes.dtype], b, n, words, float(thresh),
            int(iou_mode), mask.data_ptr(), stream))
        _raise_on("nms_scan", lib.nms_scan(
            mask.data_ptr(), valid.data_ptr(), b, n, words,
            min(quota, n), keep.data_ptr(), kept_idx.data_ptr(),
            n_kept.data_ptr(), stream))
    NMS_LAUNCHES += 1
    return keep.bool(), kept_idx, n_kept


def nms_keep(boxes, scores, cls_ids, valid, thresh, force_suppress, topk):
    """Greedy NMS keep-mask (B, N) in the boxes' own order (the JAX
    ``_nms_mask``, batched): sort by score (stable, as jnp.argsort),
    cut to the top `topk` (a box past it never suppresses and is
    dropped), run D1, unsort."""
    b, n = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    limit = n if topk is None or topk < 0 else min(int(topk), n)
    order = order[:, :limit]
    sb = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    sv = valid.gather(1, order)
    sc = None if force_suppress else cls_ids.gather(1, order)
    keep_sorted, _, _ = nms_sorted(sb, sv, sc, thresh, IOU_CORNER)
    keep = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    return keep.scatter(1, order, keep_sorted)


# ---------------------------------------------------------------------------
# multibox_prior
# ---------------------------------------------------------------------------

def _floats(v):
    return tuple(float(s) for s in (v if isinstance(v, (list, tuple))
                                    else (v,)))


@register("_contrib_MultiBoxPrior",
          aliases=("_contrib_multibox_prior", "MultiBoxPrior"),
          differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes per feature-map pixel (reference multibox_prior.cc):
    (s_i, r_0) for every size, then (s_0, r_j) for the extra ratios.
    Output (1, H*W*A, 4) float32 on data's device."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes, ratios = _floats(sizes), _floats(ratios)
    # steps/offsets are (y, x) — reference multibox_prior.cc param doc.
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = torch.float32
    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")   # (h, w)
    ws = [s * np.sqrt(ratios[0]) for s in sizes] + \
        [sizes[0] * np.sqrt(r) for r in ratios[1:]]
    hs = [s / np.sqrt(ratios[0]) for s in sizes] + \
        [sizes[0] / np.sqrt(r) for r in ratios[1:]]
    ws = torch.tensor(ws, dtype=f32, device=dev) / 2    # half extents
    hs = torch.tensor(hs, dtype=f32, device=dev) / 2
    cxg, cyg = cxg[..., None], cyg[..., None]
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


# ---------------------------------------------------------------------------
# bipartite matching + target assignment
# ---------------------------------------------------------------------------

def _greedy_bipartite(score, valid_col, max_matches=None):
    """Greedy bipartite match on score (B, N, M), batched over the first
    axis: each round takes every image's global max, assigns it and
    knocks out its row and column (reference bounding_box.cc:
    BipartiteMatching). Returns row -> col (B, N) int64, -1 unmatched.
    `valid_col` (B, M) masks padded ground truths; `max_matches` caps
    the rounds (the reference's topk)."""
    b, n, m = score.shape
    neg = torch.tensor(-1e30, dtype=score.dtype, device=score.device)
    s = torch.where(valid_col[:, None, :], score, neg)
    rounds = min(n, m)
    if max_matches is not None and max_matches >= 0:
        rounds = min(rounds, int(max_matches))
    row_match = torch.full((b, n), -1, dtype=torch.int64, device=s.device)
    img = torch.arange(b, device=s.device)
    for _ in range(rounds):
        flat = s.reshape(b, n * m)
        idx = flat.argmax(1)
        r, c = idx // m, idx % m
        ok = flat[img, idx] > 0
        row_match[img, r] = torch.where(ok, c, row_match[img, r])
        s[img, r, :] = torch.where(ok[:, None], neg, s[img, r, :])
        s[img, :, c] = torch.where(ok[:, None], neg, s[img, :, c])
    return row_match


@register("_contrib_bipartite_matching", differentiable=False)
def _bipartite_matching(dist, is_ascend=False, threshold=1e-12, topk=-1):
    """(reference bounding_box.cc:_contrib_bipartite_matching). Returns
    (row->col, col->row) assignments as float32, -1 for unmatched."""
    d = -dist if is_ascend else dist
    threshold = -threshold if is_ascend else threshold
    shape = dist.shape
    d = d.reshape((-1,) + tuple(shape[-2:]))
    b, n, m = d.shape
    shifted = d - float(np.float32(threshold)) + 1e-12
    row = _greedy_bipartite(shifted, torch.ones((b, m), dtype=torch.bool,
                                                device=d.device),
                            max_matches=topk)
    # Scatter only matched rows (unmatched go to an extra slot that is
    # dropped — a -1 fill index would clobber col[0]).
    col = torch.full((b, m + 1), -1, dtype=torch.int64, device=d.device)
    col.scatter_(1, torch.where(row >= 0, row, m),
                 torch.arange(n, device=d.device).expand(b, n))
    col = col[:, :m]
    row, col = row.to(torch.float32), col.to(torch.float32)
    return row.reshape(shape[:-1]), col.reshape(shape[:-2] + shape[-1:])


@register("_contrib_MultiBoxTarget",
          aliases=("_contrib_multibox_target", "MultiBoxTarget"),
          differentiable=False)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference multibox_target.cc).

    anchor (1, A, 4); label (B, M, 5) rows [cls, x1, y1, x2, y2], padded
    with -1; cls_pred (B, C+1, A) (the hard negatives' order). Returns
    (box_target (B, A*4), box_mask (B, A*4), cls_target (B, A)).
    """
    anchors = anchor[0]                                  # (A, 4)
    b, a_num = label.shape[0], anchors.shape[0]
    v0, v1, v2, v3 = [float(v) for v in variances]
    valid = label[:, :, 0] >= 0                          # (B, M)
    gt_boxes = label[:, :, 1:5]
    iou = _pairwise_iou(anchors, gt_boxes)               # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
    # Stage 1 — bipartite: every gt grabs its best anchor.
    anchor_gt = _greedy_bipartite(iou, valid)            # (B, A)
    matched = anchor_gt >= 0
    # Stage 2 — threshold: remaining anchors take their argmax gt if IoU
    # clears overlap_threshold.
    best_iou, best_gt = iou.max(dim=2)
    stage2 = ~matched & (best_iou >= overlap_threshold)
    anchor_gt = torch.where(stage2, best_gt, anchor_gt)
    matched = anchor_gt >= 0
    gt_idx = torch.where(matched, anchor_gt, torch.zeros_like(anchor_gt))

    # Class targets: matched -> gt class + 1; negatives -> 0; with hard
    # negative mining, surplus negatives -> ignore_label.
    gt_cls = label[:, :, 0].gather(1, gt_idx)
    cls_t = torch.where(matched, gt_cls + 1.0, torch.zeros_like(gt_cls))
    if negative_mining_ratio > 0:
        # Hard negatives come only from anchors whose best overlap is
        # below negative_mining_thresh; "hardness" = max non-background
        # prob of the prediction.
        mineable = ~matched & (best_iou < negative_mining_thresh)
        neg_score = cls_pred[:, 1:, :].max(dim=1).values   # (B, A)
        neg_score = torch.where(mineable, neg_score,
                                torch.full_like(neg_score, -float("inf")))
        num_pos = matched.sum(1)
        quota = torch.clamp_min(
            (num_pos.to(torch.float32) * negative_mining_ratio).to(
                torch.int64), int(minimum_negative_samples))
        order = torch.sort(-neg_score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a_num, device=order.device).expand(b, -1))
        keep_neg = mineable & (rank < quota[:, None])
        cls_t = torch.where(matched, cls_t, torch.where(
            keep_neg, torch.zeros_like(cls_t),
            torch.full_like(cls_t, float(np.float32(ignore_label)))))

    # Box targets: encoded offsets of the matched gt.
    g = gt_boxes.gather(1, gt_idx[..., None].expand(-1, -1, 4))
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp_min(1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp_min(1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-8)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-8)
    t = torch.stack([(gcx - acx) / aw / v0, (gcy - acy) / ah / v1,
                     torch.log(gw / aw) / v2, torch.log(gh / ah) / v3],
                    dim=-1)                              # (B, A, 4)
    mask = matched[..., None].to(torch.float32)
    box_t = (t * mask).reshape(b, -1)
    box_m = mask.expand(-1, -1, 4).reshape(b, -1)
    return box_t, box_m, cls_t


# ---------------------------------------------------------------------------
# NMS + detection decode
# ---------------------------------------------------------------------------

def _to_corner(boxes):
    cx, cy, w, h = [boxes[..., i] for i in range(4)]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("_contrib_box_nms",
          aliases=("_contrib_box_non_maximum_suppression", "box_nms"),
          differentiable=False)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression (reference bounding_box.cc:box_nms).
    data (..., N, K): suppressed entries become all -1; surviving rows'
    coordinates are rewritten to `out_format`."""
    d = data.reshape((-1,) + tuple(data.shape[-2:]))
    scores = d[..., score_index]
    boxes = d[..., coord_start:coord_start + 4]
    corners = _to_corner(boxes) if in_format == "center" else boxes
    ids = d[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    keep = nms_keep(corners, scores, ids, valid, overlap_thresh,
                    force_suppress or id_index < 0, topk)
    if out_format != in_format:
        if out_format == "corner":
            conv = corners
        else:
            x1, y1, x2, y2 = [corners[..., i] for i in range(4)]
            conv = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                y2 - y1], dim=-1)
        d = torch.cat([d[..., :coord_start], conv,
                       d[..., coord_start + 4:]], dim=-1)
    out = torch.where(keep[..., None], d, -torch.ones_like(d))
    return out.reshape(data.shape)


@register("_contrib_box_iou", aliases=("box_iou",), differentiable=False)
def _box_iou(lhs, rhs, format="corner"):
    """(reference bounding_box.cc:_contrib_box_iou)."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return _pairwise_iou(lhs, rhs)


@register("_contrib_MultiBoxDetection",
          aliases=("_contrib_multibox_detection", "MultiBoxDetection"),
          differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD inference decode + per-class NMS (reference
    multibox_detection.cc). cls_prob (B, C+1, A), loc_pred (B, A*4),
    anchor (1, A, 4) -> (B, A, 6) rows [cls_id, score, x1, y1, x2, y2],
    suppressed/background rows -1."""
    anchors = anchor[0]
    b, a_num = cls_prob.shape[0], anchors.shape[0]
    v0, v1, v2, v3 = [float(v) for v in variances]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp_min(1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp_min(1e-8)
    lp = loc_pred.reshape(b, a_num, 4)
    cx = lp[..., 0] * v0 * aw + acx
    cy = lp[..., 1] * v1 * ah + acy
    w = torch.exp(lp[..., 2] * v2) * aw / 2
    h = torch.exp(lp[..., 3] * v3) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    # Best non-background class per anchor; reported ids are 0-based over
    # foreground classes (class k of the C+1 softmax reports as k-1).
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    score, cls_id = fg.max(dim=1)
    cls_id = cls_id.to(boxes.dtype)
    valid = score > threshold
    keep = nms_keep(boxes, score, cls_id, valid, nms_threshold,
                    force_suppress, nms_topk)
    out = torch.cat([cls_id[..., None], score[..., None].to(boxes.dtype),
                     boxes], dim=-1)
    return torch.where(keep[..., None], out, -torch.ones_like(out))


# ---------------------------------------------------------------------------
# D2: ROI pooling
# ---------------------------------------------------------------------------

def _roi_geometry(rois, spatial_scale, ph, pw, h, w):
    """Per ROI: the batch index (truncated, clamped to the batch) and the
    bins' windows [hs, he) (R, ph) and [ws, we) (R, pw), in the JAX
    order: floor(y1 + i*bin_h), ceil(y1 + (i+1)*bin_h), clamped to the
    map."""
    dt = rois.dtype
    x1, y1, x2, y2 = [round_half_away(rois[:, k] * spatial_scale)
                      for k in range(1, 5)]
    rw = (x2 - x1 + 1).clamp_min(1.0)
    rh = (y2 - y1 + 1).clamp_min(1.0)
    # Divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds otherwise than D2 does.
    bin_h, bin_w = rh / torch.full_like(rh, ph), rw / torch.full_like(rw, pw)
    i = torch.arange(ph, dtype=dt, device=rois.device)
    j = torch.arange(pw, dtype=dt, device=rois.device)
    hs = torch.floor(y1[:, None] + i * bin_h[:, None]).clamp(0, h)
    he = torch.ceil(y1[:, None] + (i + 1) * bin_h[:, None]).clamp(0, h)
    ws = torch.floor(x1[:, None] + j * bin_w[:, None]).clamp(0, w)
    we = torch.ceil(x1[:, None] + (j + 1) * bin_w[:, None]).clamp(0, w)
    return rois[:, 0].to(torch.int64), (hs.long(), he.long(),
                                        ws.long(), we.long())


def roi_pool_forward_reference(data, rois, pooled_size, spatial_scale):
    """Plain PyTorch version of D2's forward: for `_ROI_POOL_CHUNK` ROIs
    at a time, gather each bin's window padded to the largest bin, mask
    the padding and take the max and its first index in row-major order
    (int32, as the kernel stores it)."""
    n, c, h, w = data.shape
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    r = rois.shape[0]
    bidx, (hs, he, ws, we) = _roi_geometry(rois, spatial_scale, ph, pw, h, w)
    bidx = bidx.clamp(0, n - 1)
    out = data.new_zeros((r, c, ph, pw))
    argmax = torch.full((r, c, ph, pw), -1, dtype=torch.int32,
                        device=data.device)
    if r == 0:
        return out, argmax
    kh = max(int((he - hs).max()), 1)
    kw = max(int((we - ws).max()), 1)
    flat = data.reshape(n, c, h * w)
    ky = torch.arange(kh, device=data.device)
    kx = torch.arange(kw, device=data.device)
    for lo in range(0, r, _ROI_POOL_CHUNK):
        sl = slice(lo, min(lo + _ROI_POOL_CHUNK, r))
        y = hs[sl, :, None] + ky                         # (r, ph, kh)
        x = ws[sl, :, None] + kx                         # (r, pw, kw)
        ok = (y[:, :, None, :, None] < he[sl, :, None, None, None]) & \
            (x[:, None, :, None, :] < we[sl, None, :, None, None])
        pix = y.clamp(max=h - 1)[:, :, None, :, None] * w + \
            x.clamp(max=w - 1)[:, None, :, None, :]      # (r, ph, pw, kh, kw)
        pix = pix.reshape(pix.shape[0], -1)
        vals = flat[bidx[sl]].gather(
            2, pix[:, None, :].expand(-1, c, -1))
        vals = vals.reshape(-1, c, ph, pw, kh * kw)
        ok = ok.reshape(-1, 1, ph, pw, kh * kw)
        vals = torch.where(ok, vals, torch.full_like(vals, -float("inf")))
        best, arg = vals.max(dim=-1)
        found = best > -float("inf")
        at = pix.reshape(-1, 1, ph, pw, kh * kw).expand(-1, c, -1, -1, -1) \
            .gather(-1, arg[..., None])[..., 0]
        base = (bidx[sl, None] * c + torch.arange(c, device=data.device)) \
            * (h * w)
        out[sl] = torch.where(found, best, torch.zeros_like(best))
        argmax[sl] = torch.where(found, base[:, :, None, None] + at,
                                 torch.full_like(at, -1)).to(torch.int32)
    return out, argmax


def roi_pool_backward_reference(grad_out, argmax, data_shape):
    """Plain PyTorch version of D2's backward: every output's gradient
    added at its argmax (in index order, on the host)."""
    grad = grad_out.new_zeros(int(np.prod(data_shape)))
    hit = argmax >= 0
    grad.index_add_(0, argmax[hit], grad_out[hit])
    return grad.reshape(data_shape)


def roi_pool_forward(data, rois, pooled_size, spatial_scale):
    """ROIPooling's (out (R, C, ph, pw), argmax (R, C, ph, pw) int32 flat
    index into data, -1 for an empty bin). A map of 2^31 elements or
    more raises. CPU tensors run the plain version; CUDA tensors launch
    D2's forward (float32 or float64)."""
    global ROI_POOL_LAUNCHES
    if data.numel() >= _ROI_POOL_MAX_ELEMENTS:
        raise ValueError("ROIPooling: a map of %d elements does not fit "
                         "its int32 argmax" % data.numel())
    if _route("ROIPooling", data):
        return roi_pool_forward_reference(data, rois, pooled_size,
                                          spatial_scale)
    _check_kernel_dtype("ROIPooling", data, rois)
    if data.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError("ROIPooling kernel: data (N, C, H, W) and rois "
                         "(R, 5), got %s and %s" % (tuple(data.shape),
                                                    tuple(rois.shape)))
    n, c, h, w = data.shape
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    r = rois.shape[0]
    out = data.new_empty((r, c, ph, pw))
    argmax = torch.empty((r, c, ph, pw), dtype=torch.int32,
                         device=data.device)
    if out.numel() == 0:
        return out, argmax
    data, rois = data.contiguous(), rois.contiguous()
    with torch.cuda.device(data.device):
        _raise_on("roi_pool_fwd", _kernels().roi_pool_fwd(
            data.data_ptr(), rois.data_ptr(), _DTYPE_CODE[data.dtype], n, c,
            h, w, r, ph, pw, float(spatial_scale), out.data_ptr(),
            argmax.data_ptr(), _stream(data.device)))
    ROI_POOL_LAUNCHES += 1
    return out, argmax


def roi_pool_backward(grad_out, argmax, data_shape):
    """The gradient of ROIPooling's input: `grad_out` added at `argmax`.
    CPU tensors run the plain version; CUDA tensors launch D2's backward,
    whose atomics add in no fixed order: under
    ``torch.use_deterministic_algorithms(True)`` it raises (warns with
    ``warn_only``)."""
    global ROI_POOL_BWD_LAUNCHES
    if _route("ROIPooling backward", grad_out):
        return roi_pool_backward_reference(grad_out, argmax, data_shape)
    if torch.are_deterministic_algorithms_enabled():
        msg = ("ROIPooling's CUDA backward adds with atomicAdd, in no fixed "
               "order; torch.use_deterministic_algorithms(True) refuses it")
        if not torch.is_deterministic_algorithms_warn_only_enabled():
            raise RuntimeError(msg)
        warnings.warn(msg)
    _check_kernel_dtype("ROIPooling backward", grad_out)
    if argmax.shape != grad_out.shape or argmax.device != grad_out.device \
            or argmax.dtype != torch.int32:
        raise ValueError("ROIPooling backward kernel: argmax must be the "
                         "forward's int32 (R, C, ph, pw) on the gradient's "
                         "device")
    grad = grad_out.new_zeros(data_shape)
    if grad_out.numel() == 0:
        return grad
    grad_out, argmax = grad_out.contiguous(), argmax.contiguous()
    with torch.cuda.device(grad_out.device):
        _raise_on("roi_pool_bwd", _kernels().roi_pool_bwd(
            grad_out.data_ptr(), argmax.data_ptr(),
            _DTYPE_CODE[grad_out.dtype], grad_out.numel(), grad.data_ptr(),
            _stream(grad_out.device)))
    ROI_POOL_BWD_LAUNCHES += 1
    return grad


class _ROIPoolingFunction(torch.autograd.Function):
    """D2's forward and backward as one differentiable function (rois
    get no gradient: rounding and floors have none)."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        out, argmax = roi_pool_forward(data, rois, pooled_size,
                                       spatial_scale)
        ctx.save_for_backward(argmax)
        ctx.data_shape = data.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        (argmax,) = ctx.saved_tensors
        return roi_pool_backward(grad, argmax, ctx.data_shape), None, \
            None, None


@register("ROIPooling", aliases=("roi_pooling",))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max-pool each ROI into a fixed grid (reference roi_pooling.cc).
    data (N, C, H, W); rois (R, 5) rows [batch_idx, x1, y1, x2, y2] in
    image coords; output (R, C, ph, pw); an empty bin gives 0."""
    pooled = (int(pooled_size[0]), int(pooled_size[1]))
    return _ROIPoolingFunction.apply(data, rois.to(data.dtype), pooled,
                                     float(spatial_scale))


# ---------------------------------------------------------------------------
# ROI align
# ---------------------------------------------------------------------------

@register("_contrib_ROIAlign", aliases=("_contrib_roi_align",))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=2):
    """Average of bilinear samples per bin (reference contrib
    roi_align.cc; Mask R-CNN ROIAlign — no coordinate rounding). A
    gather of the (R, C, ph*pw*s*s) samples, differentiated by autograd.
    sample_ratio <= 0 samples ceil(map / pooled) per bin side, as the
    JAX function does."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    n, c, h, w = data.shape
    if int(sample_ratio) > 0:
        s = int(sample_ratio)
    else:
        s = max(1, int(np.ceil(max(h / ph, w / pw))))
    dt, dev = rois.dtype, rois.device
    r = rois.shape[0]
    bidx = rois[:, 0].to(torch.int64).clamp(0, n - 1)
    x1, y1, x2, y2 = [rois[:, k] * spatial_scale for k in range(1, 5)]
    rw = (x2 - x1).clamp_min(1.0)
    rh = (y2 - y1).clamp_min(1.0)
    bin_h = (rh / ph)[:, None, None, None, None]
    bin_w = (rw / pw)[:, None, None, None, None]
    i = torch.arange(ph, dtype=dt, device=dev)[:, None, None, None]
    j = torch.arange(pw, dtype=dt, device=dev)[None, :, None, None]
    si = (torch.arange(s, dtype=dt, device=dev) + 0.5)[None, None, :, None]
    sj = (torch.arange(s, dtype=dt, device=dev) + 0.5)[None, None, None, :]
    ys = y1[:, None, None, None, None] + i * bin_h + si * bin_h / s
    xs = x1[:, None, None, None, None] + j * bin_w + sj * bin_w / s
    ys = ys.expand(r, ph, pw, s, s).reshape(r, -1)
    xs = xs.expand(r, ph, pw, s, s).reshape(r, -1)
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    ly = (ys - y0).clamp(0, 1)
    lx = (xs - x0).clamp(0, 1)
    flat = data.reshape(n, c, h * w)
    roi_of = bidx[:, None, None]
    chan = torch.arange(c, device=dev)[None, :, None]

    def tap(yy, xx):
        # (R, C, P) from the whole batch: no per-ROI copy of a map.
        return flat[roi_of, chan, (yy.long() * w + xx.long())[:, None, :]]

    ly, lx = ly[:, None, :], lx[:, None, :]
    v = (tap(y0, x0) * (1 - ly) * (1 - lx)
         + tap(y1i, x0) * ly * (1 - lx)
         + tap(y0, x1i) * (1 - ly) * lx
         + tap(y1i, x1i) * ly * lx)                      # (R, C, P)
    return v.reshape(r, c, ph, pw, s * s).mean(dim=-1)
