"""Image IO and augmenters.

Counterpart of ``mxnet_tpu/image/image.py``: ``imdecode``/``imencode``/
``imread``/``imresize``, the crop helpers, every ``Augmenter``,
``CreateAugmenter`` (:413-453), ``ImageIter`` with its
``preprocess_threads`` team (:456-661) and ``ImageRecordIterImpl``
(:664). Reference: python/mxnet/image/image.py and
src/io/iter_image_recordio_2.cc.

Two things differ from the JAX package:

* **Codecs.** PNG always goes through the port's own codec
  (:mod:`.png`, zlib + numpy), which returns what ``cv2.imdecode``
  returns bit for bit; JPEG, other formats and every resize go through
  cv2 and raise, naming cv2, where it is not installed.
* **Random draws.** The JAX augmenters draw from the global ``random``
  (and ``numpy.random`` for the lighting noise). The port's draw from
  an :class:`AugRandom` that the iterator (or decoder) owns, seeded
  from ``mx.random.seed`` unless a ``seed`` is given, in the same
  order: seeding the JAX global and the port's generator alike gives
  the same shuffle, crops and flips single-threaded. An augmenter bound
  to no iterator draws from a per-thread generator
  (:func:`default_rng`).

Decode and augment run on the host in numpy; a batch moves to the card
once (``ImageRecordIterImpl`` through a ``PrefetchingIter`` that stages
it in pinned memory and copies it on a side stream).
"""
from __future__ import annotations

import os
import random as pyrandom
import threading

import numpy as np

from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, array as nd_array
from .. import io as mxio
from .. import recordio
from . import png as _png

__all__ = ["imread", "imdecode", "imencode", "imresize", "scale_down",
           "resize_short", "fixed_crop", "random_crop", "center_crop",
           "color_normalize", "random_size_crop",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "RandomOrderAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "RandomGrayAug", "HorizontalFlipAug",
           "CastAug", "CreateAugmenter", "ImageIter", "ImageRecordIterImpl",
           "AugRandom", "bind_rng", "default_rng"]


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            "this image operation needs OpenCV (cv2), which is not "
            "installed: the port decodes and encodes PNG without it, but "
            "JPEG and other formats, and every resize, need cv2") from exc
    return cv2


class AugRandom(pyrandom.Random):
    """The generator an iterator's augmenters draw from: a
    ``random.Random`` (shuffle, crops, flips, jitter) with a
    ``numpy.random.RandomState`` beside it (``.np``, the lighting
    noise), both seeded from one seed — by default one drawn from
    ``mx.random.seed`` (``random.host_seed``)."""

    def __init__(self, seed=None):
        self.np = None
        super().__init__(seed)

    def seed(self, a=None, version=2):
        if a is None:
            from .. import random as _random

            a = _random.host_seed()
        super().seed(a, version)
        self.np = np.random.RandomState(int(a) & 0xFFFFFFFF)


_default = threading.local()


def default_rng():
    """The generator of augmenters bound to no iterator: one per thread
    and process (a forked worker draws its own, seeded anew)."""
    rng = getattr(_default, "rng", None)
    if rng is None or _default.pid != os.getpid():
        from .. import random as _random

        _default.pid = os.getpid()
        rng = _default.rng = AugRandom(
            (_random.host_seed() + _default.pid) & 0xFFFFFFFF)
    return rng


def bind_rng(augs, rng):
    """Make every augmenter of `augs` (and those nested in a
    RandomOrderAug) draw from `rng`."""
    for aug in augs:
        if isinstance(aug, Augmenter):
            aug.rng = rng
        bind_rng(getattr(aug, "ts", ()), rng)


def _unwrap(src):
    """(host numpy view, context or None). Pixel helpers are
    type-preserving: an NDArray in gives an NDArray out on its context,
    numpy in gives numpy out — the ImageIter hot path stays pure numpy."""
    if isinstance(src, NDArray):
        return src.asnumpy(), src.context
    return np.asarray(src), None


def _wrap(out, ctx):
    return nd_array(out, ctx=ctx) if ctx is not None else out


def _imdecode_np(buf, flag=1, to_rgb=True):
    """Decode to a host numpy HWC array — the decode-team hot path."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8)
    elif isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.asarray(buf, dtype=np.uint8)
    if _png.is_png(buf):
        if to_rgb and int(flag) > 0:
            return _png.decode(buf.tobytes(), int(flag), rgb=True)
        img = _png.decode(buf.tobytes(), int(flag))
    else:
        img = _cv2().imdecode(buf, int(flag))
        if img is None:
            raise ValueError("Decoding failed: invalid image data")
    if to_rgb and img.ndim == 3:
        # cv2.COLOR_BGR2RGB: channel order reversed, alpha dropped.
        img = img[..., 2::-1].copy()
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode an image byte buffer to HWC uint8 (reference image.py:imdecode
    / image_io.cc). to_rgb converts BGR->RGB like the reference. The
    NDArray lands on ``ctx`` (default: the current context)."""
    return nd_array(_imdecode_np(buf, flag=flag, to_rgb=to_rgb), ctx=ctx)


def imencode(img, quality=95, img_fmt=".jpg"):
    """Encode HWC image to bytes (used by recordio.pack_img). PNG goes
    through the port's codec; other formats need cv2."""
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = np.asarray(img)
    if img_fmt.lower() == ".png":
        return _png.encode(img)
    cv2 = _cv2()
    params = [cv2.IMWRITE_JPEG_QUALITY, int(quality)] \
        if img_fmt.lower() in (".jpg", ".jpeg") else []
    ok, buf = cv2.imencode(img_fmt, img, params)
    if not ok:
        raise ValueError("Encoding failed")
    return buf.tobytes()


def imread(filename, flag=1, to_rgb=True, ctx=None):
    """Read and decode an image file (reference image.py:imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


def imresize(src, w, h, interp=1):
    """Resize to (w, h) (reference image.py:imresize)."""
    cv2 = _cv2()
    img, wrap = _unwrap(src)
    return _wrap(cv2.resize(img, (w, h), interpolation=int(interp)), wrap)


def scale_down(src_size, size):
    """Scale target size down to fit src (reference image.py:scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge = size (reference image.py:resize_short)."""
    img, wrap = _unwrap(src)
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _wrap(imresize(img, new_w, new_h, interp=interp), wrap)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    img, wrap = _unwrap(src)
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return _wrap(imresize(out, size[0], size[1], interp=interp), wrap)
    return _wrap(out, wrap)


def random_crop(src, size, interp=2, rng=None):
    rng = rng or default_rng()
    img, wrap = _unwrap(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = rng.randint(0, w - new_w)
    y0 = rng.randint(0, h - new_h)
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return _wrap(out, wrap), (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img, wrap = _unwrap(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return _wrap(out, wrap), (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, rng=None):
    """Random crop with area/aspect constraints (inception-style,
    reference image.py:random_size_crop)."""
    rng = rng or default_rng()
    img, wrap = _unwrap(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(rng.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w)
            y0 = rng.randint(0, h - new_h)
            out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
            return _wrap(out, wrap), (x0, y0, new_w, new_h)
    out, box = center_crop(img, size, interp)
    return _wrap(out, wrap), box


def color_normalize(src, mean, std=None):
    img, wrap = _unwrap(src)
    img = img.astype(np.float32)     # a fresh array: normalized in place
    for op, value in ((np.subtract, mean), (np.divide, std)):
        if value is not None:
            value = np.asarray(value, dtype=np.float32)
            same = np.broadcast_shapes(img.shape, value.shape) == img.shape
            img = op(img, value, out=img if same else None)
    return _wrap(img, wrap)


# -- Augmenters (reference image.py:Augmenter hierarchy) ---------------------

class Augmenter:
    """Base augmenter. ``rng`` is the generator a random augmenter draws
    from (an iterator binds its own; None = :func:`default_rng`)."""

    rng = None

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def _rng(self):
        return self.rng or default_rng()

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp, rng=self._rng())[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp, rng=self._rng())[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        # Shuffle a local view: decode workers share this instance, and
        # an in-place shuffle of self.ts from two threads can corrupt
        # the list (duplicate one aug, lose another).
        order = list(self.ts)
        self._rng().shuffle(order)
        for t in order:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + self._rng().uniform(-self.brightness, self.brightness)
        img, wrap = _unwrap(src)
        return _wrap(img.astype(np.float32) * alpha, wrap)


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + self._rng().uniform(-self.contrast, self.contrast)
        img, wrap = _unwrap(src)
        img = img.astype(np.float32)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return _wrap(img * alpha + gray.mean() * (1 - alpha), wrap)


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + self._rng().uniform(-self.saturation, self.saturation)
        img, wrap = _unwrap(src)
        img = img.astype(np.float32)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return _wrap(img * alpha + gray * (1 - alpha), wrap)


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (reference image.py:HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        alpha = self._rng().uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        img, wrap = _unwrap(src)
        return _wrap(np.dot(img.astype(np.float32), t), wrap)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting noise (AlexNet-style, reference image.py:LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        alpha = self._rng().np.normal(0, self.alphastd,
                                      size=(3,)).astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        img, wrap = _unwrap(src)
        return _wrap(img.astype(np.float32) + rgb, wrap)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], dtype=np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if self._rng().random() < self.p:
            img, wrap = _unwrap(src)
            return _wrap(np.dot(img.astype(np.float32), self._mat), wrap)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if self._rng().random() < self.p:
            img, wrap = _unwrap(src)
            return _wrap(img[:, ::-1].copy(), wrap)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        img, wrap = _unwrap(src)
        return _wrap(img.astype(self.typ), wrap)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmentation pipeline factory (reference
    image.py:CreateAugmenter; C++ defaults image_aug_default.cc)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.asarray(mean).shape[0] > 0 or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(mxio.DataIter):
    """Image iterator over .rec files or an image list + directory, with
    python augmenters (reference image.py:ImageIter).

    ``preprocess_threads`` ≥ 2 decodes and augments a batch with a
    worker-thread team, the analogue of the reference's OpenMP decode
    loop in ImageRecordIOParser2 (iter_image_recordio_2.cc:75,145-155 —
    per-thread JPEG decode + augmenters writing straight into the batch).
    cv2's decode/resize release the GIL, so Python threads give true
    parallelism; record reads stay sequential (cheap framing IO), only
    the expensive pixel work fans out (zlib's inflate and numpy's large
    copies release the GIL too).

    The shuffle and the augmenters draw from one :class:`AugRandom`
    the iterator owns (``self.rng``, seeded with ``seed``; default from
    ``mx.random.seed``). Batches are NDArrays on ``ctx`` (default: the
    current context); user-supplied augmenters get host NDArrays.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", preprocess_threads=0, ctx=None,
                 seed=None, **kwargs):
        super().__init__(batch_size)
        self.ctx = ctx if ctx is not None else current_context()
        self.rng = AugRandom(seed)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.preprocess_threads = int(preprocess_threads)
        self._pool = None
        # User-supplied augmenters keep the documented NDArray input
        # contract; the built-in pipeline runs the fast numpy path.
        self._custom_augs = aug_list is not None
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                         path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
            self.imglist = None
        else:
            self.imgrec = None
            if path_imglist:
                with open(path_imglist) as fin:
                    imglist = {}
                    imgkeys = []
                    for line in iter(fin.readline, ""):
                        line = line.strip().split("\t")
                        label = np.array(line[1:-1], dtype=np.float32)
                        key = int(line[0])
                        imglist[key] = (label, line[-1])
                        imgkeys.append(key)
                    self.imglist = imglist
                    self.imgidx = imgkeys
            else:
                result = {}
                imgkeys = []
                for i, img in enumerate(imglist):
                    key = str(i)
                    label = np.array(img[0], dtype=np.float32) \
                        if not isinstance(img[0], (int, float)) \
                        else np.array([img[0]], dtype=np.float32)
                    result[key] = (label, img[1])
                    imgkeys.append(key)
                self.imglist = result
                self.imgidx = imgkeys
        self.path_root = path_root
        self.shuffle = shuffle
        self.seq = self.imgidx
        # Equal-size wrap-tail sharding (data.sharding contract): every
        # part gets ceil(N/num_parts) keys, the tail wraps to the head
        # — no record is unreachable and ranks agree on batch count.
        if num_parts > 1 and self.seq is not None:
            from ..data.sharding import shard_slice

            self.seq = shard_slice(list(self.seq), num_parts, part_index)
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        bind_rng(self.auglist, self.rng)
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [mxio.DataDesc(self.label_name,
                              (self.batch_size, self.label_width)
                              if self.label_width > 1
                              else (self.batch_size,))]

    def reset(self):
        if self.shuffle and self.seq is not None:
            self.rng.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_raw(self):
        """Return (label, raw) with decode deferred: raw is undecoded
        image bytes from the record, or a filename to read — the cheap
        sequential half of sample production."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, ("bytes", img)
            label, fname = self.imglist[idx]
            return label, ("file",
                           os.path.join(self.path_root or "", fname))
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, ("bytes", img)

    def next_sample(self):
        """Return (label, decoded image ndarray)."""
        label, (kind, payload) = self.next_raw()
        return label, (imdecode(payload) if kind == "bytes"
                       else imread(payload))

    def _decode_augment(self, raw):
        """The per-sample pixel work a worker thread runs: decode,
        augment, HWC->CHW. Stays pure numpy end to end (the type-
        preserving augmenters never touch a device buffer), and cv2
        releases the GIL, so the team decodes truly in parallel."""
        kind, payload = raw
        if kind == "bytes":
            img = _imdecode_np(payload)
        else:
            with open(payload, "rb") as f:
                img = _imdecode_np(f.read())
        if self._custom_augs:
            img = nd_array(img, ctx=cpu())
        for aug in self.auglist:
            img = aug(img)
        arr = img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)
        return arr.transpose(2, 0, 1)

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.preprocess_threads,
                thread_name_prefix="mx_decode")
        return self._pool

    def close(self):
        """Shut down the decode worker team (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def next(self):
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              dtype=np.float32)
        shape = (self.batch_size, self.label_width) if self.label_width > 1 \
            else (self.batch_size,)
        batch_label = np.zeros(shape, dtype=np.float32)

        def put_label(i, label):
            batch_label[i] = np.asarray(label, dtype=np.float32).reshape(
                batch_label[i].shape) if self.label_width > 1 else float(
                np.asarray(label).ravel()[0])

        # One batch-filling contract for both paths: pull raw records
        # sequentially, then run the pixel work either inline or fanned
        # out to the worker team (each future filling its batch slot).
        pool = self._ensure_pool() if self.preprocess_threads >= 2 else None
        pending = []
        i = 0
        pad = 0
        while i < self.batch_size:
            try:
                label, raw = self.next_raw()
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                break
            put_label(i, label)
            if pool is not None:
                pending.append((i, pool.submit(self._decode_augment, raw)))
            else:
                batch_data[i] = self._decode_augment(raw)
            i += 1
        for slot, fut in pending:
            batch_data[slot] = fut.result()  # re-raises worker errors
        return mxio.DataBatch(data=[nd_array(batch_data, ctx=self.ctx)],
                              label=[nd_array(batch_label, ctx=self.ctx)],
                              pad=pad,
                              provide_data=self.provide_data,
                              provide_label=self.provide_label)


def ImageRecordIterImpl(path_imgrec=None, data_shape=(3, 224, 224),
                        batch_size=128, shuffle=False, preprocess_threads=4,
                        prefetch_buffer=4, path_imgidx=None, mean_r=0.0,
                        mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                        std_b=1.0, rand_crop=False, rand_mirror=False,
                        resize=0, ctx=None, seed=None, **kwargs):
    """Factory behind mx.io.ImageRecordIter: ImageIter + background
    prefetch (reference C++ path: PrefetcherIter(BatchLoader(
    ImageRecordIOParser2)), iter_image_recordio_2.cc). The
    ``preprocess_threads`` decode team runs inside the prefetched
    producer, so batch N+1's decode overlaps batch N's compute. The
    ImageIter builds host batches; the PrefetchingIter delivers them on
    ``ctx`` (default: the current context), through pinned staging and
    a side-stream copy on a GPU context."""
    ctx = ctx if ctx is not None else current_context()
    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b])
    std = None
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = np.array([std_r, std_g, std_b])
    inner = ImageIter(batch_size=batch_size, data_shape=tuple(data_shape),
                      path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                      shuffle=shuffle, rand_crop=rand_crop,
                      rand_mirror=rand_mirror, resize=resize,
                      mean=mean, std=std,
                      preprocess_threads=preprocess_threads,
                      ctx=cpu(), seed=seed,
                      **{k: v for k, v in kwargs.items()
                         if k in ("label_width", "aug_list", "num_parts",
                                  "part_index", "brightness", "contrast",
                                  "saturation", "hue", "pca_noise",
                                  "rand_gray", "rand_resize")})
    return mxio.PrefetchingIter(inner, ctx=ctx)
