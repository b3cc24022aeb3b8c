"""Detection augmenters (reference: python/mxnet/image/detection.py —
DetRandomSelectAug/DetHorizontalFlipAug/DetRandomCropAug/DetRandomPadAug
used by the SSD example; C++ defaults image_det_aug_default.cc).

Counterpart of ``mxnet_tpu/image/detection.py``: the same augmenters and
``CreateDetAugmenter``, drawing from Python's global ``random`` as the
JAX ones do (seed both alike and they make the same draws). Labels are
(N, 5+) arrays [class, xmin, ymin, xmax, ymax, ...] with coordinates
normalized to [0, 1]; an augmenter transforms image and label together.
Images are host arrays: an augmenter that makes a new image returns an
NDArray on the input's context, or on the host for a numpy input.
Resizes go through cv2, as every resize of ``mx.image`` does.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np

from ..context import cpu
from ..ndarray.ndarray import NDArray, array as nd_array
from .image import fixed_crop

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
           "CreateDetAugmenter"]


def _host(src):
    """(host numpy image, the context a new image goes to)."""
    if isinstance(src, NDArray):
        return src.asnumpy(), src.context
    return np.asarray(src), cpu()


class DetAugmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only augmenter (reference detection.py:DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            img, ctx = _host(src)
            src = nd_array(img[:, ::-1].copy(), ctx=ctx)
            label = label.copy()
            tmp = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (reference detection.py:
    DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        img, _ = _host(src)
        h, w = img.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range) * h * w
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = int(np.sqrt(area * ratio))
            ch = int(np.sqrt(area / ratio))
            if cw > w or ch > h:
                continue
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            new_label = self._update_labels(label, (x0, y0, cw, ch), w, h)
            if new_label is not None:
                return fixed_crop(img, x0, y0, cw, ch), new_label
        return src, label

    def _update_labels(self, label, crop_box, w, h):
        x0, y0, cw, ch = crop_box
        box = np.array([x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h])
        coords = label[:, 1:5]
        centers = (coords[:, :2] + coords[:, 2:4]) / 2
        mask = np.logical_and(
            (centers >= box[:2]).all(axis=1),
            (centers <= box[2:]).all(axis=1))
        if not mask.any():
            return None
        # Every kept object must have >= min_object_covered of its area
        # inside the crop (the reference rejects crops below it).
        inter_w = np.minimum(coords[:, 2], box[2]) - np.maximum(coords[:, 0],
                                                                box[0])
        inter_h = np.minimum(coords[:, 3], box[3]) - np.maximum(coords[:, 1],
                                                                box[1])
        inter = np.clip(inter_w, 0, None) * np.clip(inter_h, 0, None)
        area = (coords[:, 2] - coords[:, 0]) * (coords[:, 3] - coords[:, 1])
        coverage = np.where(area > 0, inter / np.maximum(area, 1e-12), 0.0)
        if np.amin(coverage[mask]) < self.min_object_covered:
            return None
        out = label[mask].copy()
        out[:, 1:5:2] = np.clip((out[:, 1:5:2] - box[0]) / (box[2] - box[0]),
                                0, 1)
        out[:, 2:5:2] = np.clip((out[:, 2:5:2] - box[1]) / (box[3] - box[1]),
                                0, 1)
        return out


class DetRandomPadAug(DetAugmenter):
    """Random expand/pad (reference detection.py:DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(area_range=area_range)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img, ctx = _host(src)
        h, w = img.shape[:2]
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.area_range)
            if ratio <= 1.0:
                continue
            # The canvas aspect is drawn within range.
            aspect = pyrandom.uniform(*self.aspect_ratio_range)
            nh = int(h * np.sqrt(ratio / aspect))
            nw = int(w * np.sqrt(ratio * aspect))
            if nh <= h or nw <= w:
                continue
            y0 = pyrandom.randint(0, nh - h)
            x0 = pyrandom.randint(0, nw - w)
            out = np.full((nh, nw) + img.shape[2:], 0, dtype=img.dtype)
            out[..., :] = np.asarray(self.pad_val, dtype=img.dtype)
            out[y0:y0 + h, x0:x0 + w] = img
            new_label = label.copy()
            new_label[:, 1:5:2] = (label[:, 1:5:2] * w + x0) / nw
            new_label[:, 2:5:2] = (label[:, 2:5:2] * h + y0) / nh
            return nd_array(out, ctx=ctx), new_label
        return src, label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several augmenters (reference detection.py:
    DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), pad_val=(127, 127, 127),
                       **kwargs):
    """(reference detection.py:CreateDetAugmenter)."""
    from .image import (CastAug, ColorNormalizeAug, ForceResizeAug,
                        ResizeAug)

    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])))
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist
