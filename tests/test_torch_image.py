"""``mxnet_tpu_torch.image`` against the JAX package's ``mxnet_tpu.image``
and against OpenCV, on images made from a seed with numpy.

- The port's PNG codec returns what ``cv2.imdecode`` returns, bit for
  bit, on cv2's encodings (every row filter, gray/BGR/BGRA, PIL's gray
  and gray+alpha) and on its own, for flags 1, 0 and -1.
- Every deterministic augmenter equals the JAX package's exactly; the
  random ones do too when the JAX globals (``random``, ``numpy.random``)
  and the port's generator are seeded alike, single-threaded.
- ``ImageIter`` and ``ImageRecordIter`` batches, ``pad`` included, equal
  the JAX package's: exact (rtol 0) for the normalized float32 data.
"""
import io
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.image import png

cv2 = pytest.importorskip("cv2")


def _images(seed=0, h=21, w=34):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.dstack([(xx * 3 + yy) % 256, (yy * 5) % 256,
                        (xx * yy) % 256]).astype(np.uint8)
    noisy = (smooth + rng.randint(0, 4, smooth.shape)).astype(np.uint8)
    return {
        "bgr_noise": rng.randint(0, 256, (h, w, 3), np.uint8),
        "bgr_smooth": noisy,
        "gray": noisy[..., 1].copy(),
        "bgra": np.dstack([noisy, rng.randint(0, 256, (h, w, 1), np.uint8)]),
    }


FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


@pytest.mark.parametrize("kind", ["bgr_noise", "bgr_smooth", "gray", "bgra"])
@pytest.mark.parametrize("flt", FILTERS)
def test_png_decode_equals_cv2_on_cv2_encodings(kind, flt):
    img = _images()[kind]
    ok, buf = cv2.imencode(".png", img, [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, "IMWRITE_PNG_FILTER_" + flt)])
    assert ok
    for flag in (1, 0, -1):
        want = cv2.imdecode(buf, flag)
        got = png.decode(buf.tobytes(), flag)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bgr_noise", "bgr_smooth", "gray", "bgra"])
def test_png_encode_reads_back_in_cv2(kind):
    img = _images(seed=1)[kind]
    buf = png.encode(img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED), img)
    for flag in (1, 0, -1):
        np.testing.assert_array_equal(
            png.decode(buf, flag),
            cv2.imdecode(np.frombuffer(buf, np.uint8), flag))


@pytest.mark.parametrize("mode", ["L", "LA"])
def test_png_decode_equals_cv2_on_pil_gray(mode):
    PIL = pytest.importorskip("PIL.Image")
    img = _images(seed=2)["bgra"]
    arr = img[..., 1] if mode == "L" else img[..., 1:3]
    bio = io.BytesIO()
    PIL.fromarray(arr, mode=mode).save(bio, format="PNG", optimize=True)
    buf = bio.getvalue()
    for flag in (1, 0, -1):
        np.testing.assert_array_equal(
            png.decode(buf, flag),
            cv2.imdecode(np.frombuffer(buf, np.uint8), flag))


def test_png_rejects_what_it_does_not_read():
    ok, buf = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(NotImplementedError, match="cv2"):
        png.decode(buf.tobytes())
    with pytest.raises(ValueError, match="PNG"):
        png.decode(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("to_rgb", [True, False])
@pytest.mark.parametrize("flag", [1, 0])
def test_imdecode_equals_jax(to_rgb, flag):
    img = _images(seed=3)["bgr_smooth"]
    for fmt in (".png", ".jpg"):
        buf = image.imencode(img, img_fmt=fmt)
        want = jimage.imdecode(buf, flag=flag, to_rgb=to_rgb).asnumpy()
        got = image.imdecode(buf, flag=flag, to_rgb=to_rgb, ctx=mx.cpu())
        assert got.context == mx.cpu()
        np.testing.assert_array_equal(got.asnumpy(), want)


def test_without_cv2_png_works_and_jpeg_names_cv2(monkeypatch):
    img = _images(seed=4)["bgr_noise"]
    jpg = image.imencode(img, img_fmt=".jpg")

    def missing():
        raise ImportError("this image operation needs OpenCV (cv2)")

    monkeypatch.setattr(image.image, "_cv2", missing)
    buf = image.imencode(img, img_fmt=".png")
    np.testing.assert_array_equal(image.image._imdecode_np(buf, to_rgb=False),
                                  img)
    with pytest.raises(ImportError, match="cv2"):
        image.image._imdecode_np(jpg)
    with pytest.raises(ImportError, match="cv2"):
        image.imresize(img, 8, 8)


def _hwc(seed=5, h=30, w=40):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("make", [
    lambda m: m.ResizeAug(24, 2),
    lambda m: m.ForceResizeAug((17, 23), 1),
    lambda m: m.CenterCropAug((20, 16), 2),
    lambda m: m.CenterCropAug((50, 60), 1),
    lambda m: m.CastAug("float32"),
    lambda m: m.ColorNormalizeAug(np.array([123.68, 116.28, 103.53]),
                                  np.array([58.395, 57.12, 57.375])),
], ids=["resize", "force_resize", "center_crop", "center_crop_up", "cast",
        "normalize"])
def test_deterministic_augmenters_equal_jax(make):
    src = _hwc()
    np.testing.assert_array_equal(make(image)(src), make(jimage)(src))


def test_crop_helpers_equal_jax():
    src = _hwc(seed=6)
    assert image.scale_down((40, 30), (50, 20)) == \
        jimage.scale_down((40, 30), (50, 20))
    np.testing.assert_array_equal(image.resize_short(src, 20),
                                  jimage.resize_short(src, 20))
    np.testing.assert_array_equal(image.fixed_crop(src, 3, 4, 10, 12, (8, 8)),
                                  jimage.fixed_crop(src, 3, 4, 10, 12, (8, 8)))
    got, box = image.center_crop(src, (16, 12))
    want, wbox = jimage.center_crop(src, (16, 12))
    np.testing.assert_array_equal(got, want)
    assert box == wbox
    np.testing.assert_array_equal(image.color_normalize(src, 10.0, 3.0),
                                  jimage.color_normalize(src, 10.0, 3.0))
    nd = image.center_crop(mx.nd.array(src, ctx=mx.cpu(), dtype="uint8"),
                           (16, 12))[0]
    assert isinstance(nd, mx.nd.NDArray) and nd.context == mx.cpu()
    np.testing.assert_array_equal(nd.asnumpy(), want)


RANDOM_AUGS = {
    "random_crop": lambda m: [m.RandomCropAug((20, 16), 2)],
    "random_sized_crop": lambda m: [m.RandomSizedCropAug(
        (16, 16), (0.08, 1.0), (3 / 4, 4 / 3), 2)],
    "flip": lambda m: [m.HorizontalFlipAug(0.5)],
    "brightness": lambda m: [m.CastAug(), m.BrightnessJitterAug(0.4)],
    "contrast": lambda m: [m.CastAug(), m.ContrastJitterAug(0.4)],
    "saturation": lambda m: [m.CastAug(), m.SaturationJitterAug(0.4)],
    "hue": lambda m: [m.CastAug(), m.HueJitterAug(0.3)],
    "color_jitter": lambda m: [m.CastAug(), m.ColorJitterAug(0.3, 0.3, 0.3)],
    "lighting": lambda m: [m.CastAug(), m.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]))],
    "gray": lambda m: [m.CastAug(), m.RandomGrayAug(0.5)],
    "create_all": lambda m: m.CreateAugmenter(
        (3, 16, 16), resize=24, rand_crop=True, rand_resize=True,
        rand_mirror=True, mean=True, std=True, brightness=0.2, contrast=0.2,
        saturation=0.2, hue=0.1, pca_noise=0.1, rand_gray=0.3),
}


@pytest.mark.parametrize("name", sorted(RANDOM_AUGS))
def test_seeded_random_augmenters_equal_jax(name):
    seed = 11
    port_augs = RANDOM_AUGS[name](image)
    image.bind_rng(port_augs, image.AugRandom(seed))
    jax_augs = RANDOM_AUGS[name](jimage)
    random.seed(seed)
    np.random.seed(seed)
    for i in range(6):
        src = _hwc(seed=20 + i)
        got, want = src, src
        for a in port_augs:
            got = a(got)
        for a in jax_augs:
            want = a(want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _write_png_rec(pkg, path, n=13, seed=7, side=(28, 36), vector=False):
    rng = np.random.RandomState(seed)
    rec, idx = str(path / "img.rec"), str(path / "img.idx")
    w = pkg.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, side + (3,), np.uint8)
        label = rng.rand(3).astype(np.float32) if vector \
            else float(rng.randint(0, 10))
        w.write_idx(i, pkg.pack_img(pkg.IRHeader(0, label, i, 0), img,
                                    img_fmt=".png"))
    w.close()
    return rec, idx


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("use_idx", [True, False])
def test_image_iter_random_augs_equal_jax_single_threaded(tmp_path, use_idx):
    rec, idx = _write_png_rec(recordio, tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 20, 24), path_imgrec=rec,
              path_imgidx=idx if use_idx else None, shuffle=use_idx,
              rand_crop=True, rand_mirror=True, mean=True, std=True,
              brightness=0.1)
    it = image.ImageIter(ctx=mx.cpu(), seed=5, **kw)
    got = _batches(it)
    random.seed(5)
    np.random.seed(5)
    want = _batches(jimage.ImageIter(**kw))
    _assert_same_batches(got, want)
    assert got[-1][2] == 3          # 13 records at batch 4


def test_image_iter_threads_with_deterministic_augs_equal_jax(tmp_path):
    rec, idx = _write_png_rec(recordio, tmp_path, vector=True)
    kw = dict(batch_size=5, data_shape=(3, 20, 24), path_imgrec=rec,
              path_imgidx=idx, label_width=3, mean=True, std=True,
              preprocess_threads=3)
    it = image.ImageIter(ctx=mx.cpu(), **kw)
    got = _batches(it)
    it.close()
    jit = jimage.ImageIter(**kw)
    want = _batches(jit)
    jit.close()
    _assert_same_batches(got, want)


def test_image_iter_imglist_equals_jax(tmp_path):
    rng = np.random.RandomState(8)
    files = []
    for i in range(5):
        name = "im%d.png" % i
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 256, (24, 26, 3), np.uint8))
        files.append((float(i % 3), name))
    kw = dict(batch_size=2, data_shape=(3, 16, 16), imglist=files,
              path_root=str(tmp_path))
    got = _batches(image.ImageIter(ctx=mx.cpu(), **kw))
    _assert_same_batches(got, _batches(jimage.ImageIter(**kw)))


def test_image_record_iter_equals_jax(tmp_path):
    rec, idx = _write_png_rec(jrio, tmp_path, n=11)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 20, 20),
              batch_size=4, shuffle=True, preprocess_threads=0,
              mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
              std_g=57.0, std_b=57.5, rand_crop=True, rand_mirror=True)
    it = mx.io.ImageRecordIter(ctx=mx.cpu(), seed=9, **kw)
    got = _batches(it)
    it.close()
    random.seed(9)
    np.random.seed(9)
    jit = jmx.io.ImageRecordIter(**kw)
    want = _batches(jit)
    jit.close()
    _assert_same_batches(got, want)
    assert [g[2] for g in got] == [0, 0, 1]


def test_image_iter_worker_error_surfaces(tmp_path):
    rec, idx = str(tmp_path / "bad.rec"), str(tmp_path / "bad.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(4):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, 1.0, i, 0),
                                     b"not an image"))
    w.close()
    it = image.ImageIter(batch_size=2, data_shape=(3, 8, 8), path_imgrec=rec,
                         path_imgidx=idx, preprocess_threads=2, ctx=mx.cpu())
    with pytest.raises((ValueError, ImportError)):
        it.next()
    it.close()


def test_iterator_generator_follows_mx_random_seed(tmp_path):
    rec, idx = _write_png_rec(recordio, tmp_path, n=8)
    kw = dict(batch_size=4, data_shape=(3, 16, 16), path_imgrec=rec,
              path_imgidx=idx, shuffle=True, rand_crop=True, ctx=mx.cpu())
    runs = []
    for _ in range(2):
        mx.random.seed(42)
        runs.append(_batches(image.ImageIter(**kw)))
    _assert_same_batches(runs[0], runs[1])
    mx.random.seed(43)
    other = _batches(image.ImageIter(**kw))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(runs[0], other))
