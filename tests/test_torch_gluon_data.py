"""``mxnet_tpu_torch.gluon.data`` against the JAX package's
``mxnet_tpu.gluon.data``, on numpy data and files made from a seed.

- ``DataLoader`` batches equal the JAX package's exactly at
  ``num_workers`` 0, 2 (forked processes) and a thread pool, over every
  ``last_batch`` mode, sequential and seeded-random sampling (the JAX
  global ``numpy.random`` and the port's sampler generator seeded
  alike).
- A forked worker over an ``ArrayDataset`` built from NDArrays works;
  a dataset handing a worker a tensor that is not on the host raises a
  clear error in the consumer instead of hanging; a worker's exception
  re-raises at ``next()``; ``pin_memory=True`` raises without a card.
- The vision datasets read files the test writes (idx-ubyte, CIFAR
  binary, RecordIO, an image folder) and equal the JAX package's;
  the transforms equal the JAX package's (random ones seeded alike).
"""
import os
import random
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.vision import transforms as T

CPU = mx.cpu()
jgdata = jmx.gluon.data


def _arrays(seed=0, n=11):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 4).astype(np.float32),
            rng.randint(0, 7, n).astype(np.int32))


def _collect(loader):
    out = []
    with CPU:
        for batch in loader:
            out.append([np.asarray(b.asnumpy() if hasattr(b, "asnumpy")
                                   else b) for b in batch])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers,thread_pool", [(0, False), (2, False),
                                                  (2, True)])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_equals_jax(workers, thread_pool, last_batch):
    x, y = _arrays()
    loader = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=4,
                              last_batch=last_batch, num_workers=workers,
                              thread_pool=thread_pool)
    jloader = jgdata.DataLoader(jgdata.ArrayDataset(x, y), batch_size=4,
                                last_batch=last_batch, num_workers=workers,
                                thread_pool=thread_pool)
    try:
        for _ in range(2):      # rollover carries into the second epoch
            got, want = _collect(loader), _collect(jloader)
            _assert_same(got, want)
            assert len(loader) == len(jloader)
        assert got[0][0].dtype == np.float32
    finally:
        loader.close()


def test_random_sampler_equals_jax_epoch_after_epoch():
    x, y = _arrays(seed=1, n=9)
    np.random.seed(4)
    jloader = jgdata.DataLoader(jgdata.ArrayDataset(x, y), batch_size=3,
                                shuffle=True)
    loader = gdata.DataLoader(
        gdata.ArrayDataset(x, y), batch_size=3,
        sampler=gdata.RandomSampler(9, rng=np.random.RandomState(4)))
    for _ in range(3):
        _assert_same(_collect(loader), _collect(jloader))


def test_forked_workers_over_an_ndarray_dataset():
    x, y = _arrays(seed=2, n=8)
    ds = gdata.ArrayDataset(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
    assert isinstance(ds[0][0], np.ndarray)
    with gdata.DataLoader(ds, batch_size=4, num_workers=2) as loader:
        got = _collect(loader)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), x)


class _OffHost(gdata.Dataset):
    """Samples made in the parent on a device other than the host (the
    meta device here; the card in the ``cuda`` test)."""

    def __init__(self, device):
        self.items = [torch.zeros(3, device=device) for _ in range(4)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_a_worker_handed_an_off_host_tensor_raises_clearly():
    with gdata.DataLoader(_OffHost("meta"), batch_size=2,
                          num_workers=2) as loader:
        with pytest.raises(RuntimeError, match="not touch the card"):
            next(iter(loader))


class _Raising(gdata.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise KeyError("bad sample %d" % i)
        return np.float32(i)


@pytest.mark.parametrize("thread_pool", [False, True])
def test_worker_errors_reraise_in_the_consumer(thread_pool):
    with gdata.DataLoader(_Raising(), batch_size=2, num_workers=2,
                          thread_pool=thread_pool) as loader:
        it = iter(loader)
        with CPU:
            np.testing.assert_array_equal(next(it).asnumpy(), [0.0, 1.0])
            with pytest.raises(RuntimeError, match="bad sample 3"):
                next(it)


def test_pin_memory_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = _arrays()
    with pytest.raises(RuntimeError, match="CUDA"):
        gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=2,
                         pin_memory=True)


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_pin_memory_places_on_the_card(workers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = _arrays(seed=3, n=16)
    ds = gdata.ArrayDataset(mx.nd.array(x, ctx=mx.gpu(0)),
                            mx.nd.array(y, ctx=mx.gpu(0)))
    with gdata.DataLoader(ds, batch_size=4, num_workers=workers,
                          pin_memory=True) as loader:
        got = []
        for xb, yb in loader:
            assert xb.context == mx.gpu(0)
            got.append((xb.data_ + 0).cpu().numpy())
    np.testing.assert_array_equal(np.concatenate(got), x)
    with gdata.DataLoader(_OffHost("cuda"), batch_size=2,
                          num_workers=2) as loader:
        with pytest.raises(RuntimeError, match="not touch the card"):
            next(iter(loader))


def _idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 + arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_datasets_equal_jax(tmp_path, cls):
    rng = np.random.RandomState(5)
    _idx(str(tmp_path / "train-images-idx3-ubyte"),
         rng.randint(0, 256, (6, 5, 4)).astype(np.uint8))
    _idx(str(tmp_path / "train-labels-idx1-ubyte"),
         rng.randint(0, 10, 6).astype(np.uint8))
    ds = getattr(gdata.vision, cls)(root=str(tmp_path))
    jds = getattr(jgdata.vision, cls)(root=str(tmp_path))
    assert len(ds) == len(jds) == 6
    for i in range(6):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
        assert ds[i][1] == jds[i][1]
    with pytest.raises(FileNotFoundError, match="downloads no dataset"):
        gdata.vision.MNIST(root=str(tmp_path), train=False)


@pytest.mark.parametrize("cls,label_bytes", [("CIFAR10", 1), ("CIFAR100", 2)])
def test_cifar_datasets_equal_jax(tmp_path, cls, label_bytes):
    rng = np.random.RandomState(6)
    names = ["data_batch_%d.bin" % i for i in range(1, 6)] \
        if cls == "CIFAR10" else ["train.bin"]
    for name in names:
        rec = np.concatenate([rng.randint(0, 10, (3, label_bytes)),
                              rng.randint(0, 256, (3, 3072))], axis=1)
        rec.astype(np.uint8).tofile(str(tmp_path / name))
    ds = getattr(gdata.vision, cls)(root=str(tmp_path))
    jds = getattr(jgdata.vision, cls)(root=str(tmp_path))
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
        assert ds[i][1] == jds[i][1]


def test_image_record_and_folder_datasets_equal_jax(tmp_path):
    import cv2

    rng = np.random.RandomState(7)
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(4):
        img = rng.randint(0, 256, (10, 12, 3), np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         img, img_fmt=".png"))
        os.makedirs(str(tmp_path / "folder" / ("c%d" % (i % 2))),
                    exist_ok=True)
        cv2.imwrite(str(tmp_path / "folder" / ("c%d" % (i % 2)) /
                        ("%d.png" % i)), img)
    w.close()
    pairs = [(gdata.vision.ImageRecordDataset(rec),
              jgdata.vision.ImageRecordDataset(rec)),
             (gdata.vision.ImageFolderDataset(str(tmp_path / "folder")),
              jgdata.vision.ImageFolderDataset(str(tmp_path / "folder")))]
    for ds, jds in pairs:
        assert len(ds) == len(jds) == 4
        for i in range(4):
            assert isinstance(ds[i][0], np.ndarray)
            np.testing.assert_array_equal(ds[i][0], jds[i][0].asnumpy())
            np.testing.assert_array_equal(ds[i][1], jds[i][1])
    with gdata.DataLoader(pairs[0][0].transform_first(T.ToTensor()),
                          batch_size=2, num_workers=2) as loader:
        got = _collect(loader)
    assert got[0][0].shape == (2, 3, 10, 12)


def test_deterministic_transforms_equal_jax():
    img = np.random.RandomState(8).randint(0, 256, (20, 18, 3), np.uint8)
    for make in (lambda m: m.Compose([m.ToTensor(),
                                      m.Normalize((0.4, 0.5, 0.6),
                                                  (0.2, 0.25, 0.3))]),
                 lambda m: m.Cast("float16"),
                 lambda m: m.Resize(12),
                 lambda m: m.Resize(12, keep_ratio=True),
                 lambda m: m.CenterCrop((9, 7)),
                 lambda m: m.CenterCrop(30)):
        np.testing.assert_array_equal(make(T)(img), make(jT)(img))


RANDOM_TRANSFORMS = {
    "resized_crop": lambda m, **k: m.RandomResizedCrop(8, **k),
    "flip_lr": lambda m, **k: m.RandomFlipLeftRight(**k),
    "flip_tb": lambda m, **k: m.RandomFlipTopBottom(**k),
    "brightness": lambda m, **k: m.RandomBrightness(0.3, **k),
    "contrast": lambda m, **k: m.RandomContrast(0.3, **k),
    "saturation": lambda m, **k: m.RandomSaturation(0.3, **k),
    "hue": lambda m, **k: m.RandomHue(0.2, **k),
    "color_jitter": lambda m, **k: m.RandomColorJitter(0.2, 0.2, 0.2, 0.1,
                                                       **k),
    "lighting": lambda m, **k: m.RandomLighting(0.1, **k),
}


@pytest.mark.parametrize("name", sorted(RANDOM_TRANSFORMS))
def test_seeded_random_transforms_equal_jax(name):
    t = RANDOM_TRANSFORMS[name](T, rng=np.random.RandomState(13))
    jt = RANDOM_TRANSFORMS[name](jT)
    np.random.seed(13)
    random.seed(13)
    for i in range(5):
        img = np.random.RandomState(30 + i).randint(0, 256, (16, 14, 3),
                                                    np.uint8)
        np.testing.assert_array_equal(t(img), jt(img))
