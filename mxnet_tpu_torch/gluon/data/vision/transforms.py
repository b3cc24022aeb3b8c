"""Vision transforms.

Reference: python/mxnet/gluon/data/vision/transforms.py (Compose, Cast,
ToTensor, Normalize, Resize, CenterCrop, RandomResizedCrop,
RandomFlipLeftRight/TopBottom, RandomBrightness/Contrast/Saturation/Hue,
RandomColorJitter, RandomLighting).

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py``: transforms
run on the host inside DataLoader workers (numpy; cv2 for resizing and
hue), not as device ops — the card sees one already-augmented batch.
They accept and return numpy arrays (NDArrays are unwrapped), so they
pickle cleanly into worker processes. The random transforms draw from an
explicit generator (``rng``, a ``numpy.random.RandomState``) where the
JAX package draws from the global ``numpy.random``; without one they
draw from :func:`default_rng`, a per-process generator seeded from
``mx.random.seed`` and the process id, so forked workers do not repeat
each other's draws.
"""
from __future__ import annotations

import os

import numpy as np

from ....ndarray.ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "default_rng"]

_default = {}


def default_rng():
    """This process's generator for transforms given no ``rng``."""
    pid = os.getpid()
    rng = _default.get(pid)
    if rng is None:
        from .... import random as _random

        rng = _default[pid] = np.random.RandomState(
            (_random.host_seed() + pid) & 0xFFFFFFFF)
    return rng


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


class Block:
    """Minimal callable-transform base (reference transforms are gluon
    Blocks; here host-side functions — see module docstring)."""

    _rng_state = None

    def _rng(self):
        return self._rng_state if self._rng_state is not None \
            else default_rng()

    def __call__(self, x):
        return self.forward(_np(x))

    def forward(self, x):
        raise NotImplementedError

    def hybridize(self, *a, **k):
        pass


class Compose(Block):
    """Chain transforms (reference transforms.py:Compose)."""

    def __init__(self, transforms):
        self._transforms = list(transforms)

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(Block):
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference
    transforms.py:ToTensor)."""

    def forward(self, x):
        x = x.astype(np.float32) / 255.0
        if x.ndim == 2:
            x = x[:, :, None]
        return np.transpose(x, (2, 0, 1))


class Normalize(Block):
    """(x - mean) / std per channel on a CHW tensor (reference
    transforms.py:Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (x - self._mean) / self._std


def _cv2():
    from ....image.image import _cv2 as cv2

    return cv2()


_INTERP = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4}  # cv2 codes match mx interp


class Resize(Block):
    """Resize to (w, h) or short-side int (reference
    transforms.py:Resize)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        cv2 = _cv2()
        h, w = x.shape[:2]
        if isinstance(self._size, int):
            if self._keep:
                if h > w:
                    new_w, new_h = self._size, int(h * self._size / w)
                else:
                    new_w, new_h = int(w * self._size / h), self._size
            else:
                new_w = new_h = self._size
        else:
            new_w, new_h = self._size
        out = cv2.resize(x, (new_w, new_h),
                         interpolation=_INTERP.get(self._interp, 1))
        return out if out.ndim == x.ndim else out[..., None]


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        cw, ch = self._size
        h, w = x.shape[:2]
        if h < ch or w < cw:
            return Resize((cw, ch), interpolation=self._interp)(x)
        x0 = (w - cw) // 2
        y0 = (h - ch) // 2
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(Block):
    """Random area+aspect crop then resize (reference
    transforms.py:RandomResizedCrop; Inception-style augmentation)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1, rng=None):
        self._rng_state = rng
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        cv2 = _cv2()
        rng = self._rng()
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = rng.randint(0, w - cw + 1)
                y0 = rng.randint(0, h - ch + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw]
                out = cv2.resize(crop, self._size,
                                 interpolation=_INTERP.get(self._interp, 1))
                return out if out.ndim == x.ndim else out[..., None]
        return CenterCrop(self._size)(x)


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5, rng=None):
        self._p = p
        self._rng_state = rng

    def forward(self, x):
        if self._rng().rand() < self._p:
            return x[:, ::-1].copy()
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5, rng=None):
        self._p = p
        self._rng_state = rng

    def forward(self, x):
        if self._rng().rand() < self._p:
            return x[::-1].copy()
        return x


class _RandomJitter(Block):
    def __init__(self, value, rng=None):
        self._value = max(0.0, value)
        self._rng_state = rng

    def _alpha(self):
        return 1.0 + self._rng().uniform(-self._value, self._value)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        out = x.astype(np.float32) * self._alpha()
        return np.clip(out, 0, 255).astype(x.dtype) \
            if x.dtype == np.uint8 else out


class RandomContrast(_RandomJitter):
    def forward(self, x):
        alpha = self._alpha()
        gray = x.astype(np.float32).mean()
        out = x.astype(np.float32) * alpha + gray * (1 - alpha)
        return np.clip(out, 0, 255).astype(x.dtype) \
            if x.dtype == np.uint8 else out


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        alpha = self._alpha()
        gray = x.astype(np.float32).mean(axis=-1, keepdims=True)
        out = x.astype(np.float32) * alpha + gray * (1 - alpha)
        return np.clip(out, 0, 255).astype(x.dtype) \
            if x.dtype == np.uint8 else out


class RandomHue(_RandomJitter):
    """Hue rotation in HSV space (reference transforms.py:RandomHue)."""

    def forward(self, x):
        cv2 = _cv2()
        alpha = self._rng().uniform(-self._value, self._value)
        u8 = x.dtype == np.uint8
        img = x if u8 else np.clip(x, 0, 255).astype(np.uint8)
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        hsv = hsv.astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(alpha * 180)) % 180
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return out if u8 else out.astype(x.dtype)


class RandomColorJitter(Block):
    """brightness/contrast/saturation/hue in random order (reference
    transforms.py:RandomColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None):
        self._rng_state = rng
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness, rng))
        if contrast:
            self._ts.append(RandomContrast(contrast, rng))
        if saturation:
            self._ts.append(RandomSaturation(saturation, rng))
        if hue:
            self._ts.append(RandomHue(hue, rng))

    def forward(self, x):
        order = self._rng().permutation(len(self._ts))
        for i in order:
            x = self._ts[i](x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference transforms.py:RandomLighting)."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha=0.05, rng=None):
        self._alpha = alpha
        self._rng_state = rng

    def forward(self, x):
        a = self._rng().normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        out = x.astype(np.float32) + rgb
        return np.clip(out, 0, 255).astype(x.dtype) \
            if x.dtype == np.uint8 else out
