"""The port's detection augmenters (``image/detection.py``) against the
JAX package's.

Both draw from Python's global ``random``: each case seeds it alike
before each package's run, feeds the same image (uint8 HWC) and label
rows [class, x1, y1, x2, y2] (normalized), and the images and labels that
come out must be equal (resizes go through cv2 in both packages).
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.image import detection as jdet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.image import detection as tdet

pytest.importorskip("cv2")


def _sample(seed, h=40, w=56):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.3, 0.9, 0.8],
                      [2, 0.05, 0.55, 0.3, 0.95]], np.float32)
    return img, label


def _np(img):
    return img.asnumpy() if hasattr(img, "asnumpy") else np.asarray(img)


def _run(augs, img, label, seed, draws=6):
    """The chain `augs` over `draws` passes, Python's random seeded."""
    random.seed(seed)
    outs = []
    for _ in range(draws):
        src, lab = img, label
        for aug in augs:
            src, lab = aug(src, lab)
        outs.append((_np(src), np.asarray(lab)))
    return outs


def _same(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == wi.shape and gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gl, wl, rtol=1e-6, atol=1e-7)


def test_the_port_exports_what_the_jax_package_exports():
    assert tdet.__all__ == jdet.__all__
    for name in jdet.__all__:
        assert getattr(timage, name) is getattr(tdet, name)


CASES = {
    "flip": lambda m: [m.DetHorizontalFlipAug(0.5)],
    "crop": lambda m: [m.DetRandomCropAug(0.3, (0.75, 1.33), (0.1, 1.0))],
    "pad": lambda m: [m.DetRandomPadAug((0.75, 1.33), (1.0, 3.0),
                                        pad_val=(10, 20, 30))],
    "select": lambda m: [m.DetRandomSelectAug(
        [m.DetRandomCropAug(), m.DetRandomPadAug()], skip_prob=0.3)],
    "crop_pad_flip": lambda m: [
        m.DetRandomSelectAug([m.DetRandomCropAug(0.5)], 0.2),
        m.DetRandomSelectAug([m.DetRandomPadAug()], 0.2),
        m.DetHorizontalFlipAug(0.5)],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_augmenter_matches_jax(case, seed):
    img, label = _sample(seed)
    want = _run(CASES[case](jdet), img, label, seed)
    with mx.cpu():
        got = _run(CASES[case](tdet), img, label, seed)
    _same(got, want)


@pytest.mark.parametrize("kw", [
    {"data_shape": (3, 32, 32)},
    {"data_shape": (3, 32, 48), "resize": 40, "rand_crop": 0.5,
     "rand_pad": 0.5, "rand_mirror": True},
    {"data_shape": (3, 24, 24), "rand_crop": 1, "rand_mirror": True,
     "mean": np.array([123.0, 117.0, 104.0]),
     "std": np.array([58.0, 57.0, 57.0])},
], ids=["resize_only", "crop_pad_mirror", "normalize"])
def test_create_det_augmenter_matches_jax(kw):
    img, label = _sample(3)
    jaugs, taugs = jdet.CreateDetAugmenter(**kw), tdet.CreateDetAugmenter(**kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]
    want = _run(jaugs, jmx.nd.array(img), label, 5)
    with mx.cpu():
        got = _run(taugs, mx.nd.array(img, ctx=mx.cpu()), label, 5)
    _same(got, want)


def test_a_flipped_ndarray_stays_on_its_context():
    img, label = _sample(4)
    src = mx.nd.array(img, ctx=mx.cpu())
    out, lab = tdet.DetHorizontalFlipAug(1.0)(src, label)
    assert out.context == mx.cpu()
    np.testing.assert_array_equal(out.asnumpy(), img[:, ::-1])
    np.testing.assert_allclose(lab[:, [1, 3]], 1.0 - label[:, [3, 1]])
