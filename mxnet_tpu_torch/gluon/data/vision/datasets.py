"""Vision datasets.

Reference: python/mxnet/gluon/data/vision/datasets.py (MNIST :36,
FashionMNIST, CIFAR10 :125, CIFAR100, ImageRecordDataset :247,
ImageFolderDataset :268).

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``: readers
parse the standard on-disk formats (idx-ubyte, CIFAR binary, RecordIO,
image folders) from a local ``root``, and download nothing: where the
files are absent they raise. Samples come out as host numpy (HWC uint8
image, scalar label) — ``ImageRecordDataset`` and ``ImageFolderDataset``
included, where the JAX package hands NDArrays — so forked DataLoader
workers never touch the card; placement happens at the DataLoader batch
boundary.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from .. import dataset
from ....image import image as _image
from .... import recordio

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(dataset.Dataset):
    """Base for datasets materialized under `root`
    (reference datasets.py:_DownloadedDataset)."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(
        "%s(.gz) not found: the port downloads no dataset; place the "
        "dataset files under the dataset root first." % path)


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files (reference datasets.py:MNIST :36)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        image_file, label_file = self._train_files if self._train \
            else self._test_files
        with _open_maybe_gz(os.path.join(self._root, label_file)) as f:
            magic, n = struct.unpack(">II", f.read(8))
            self._label = np.frombuffer(f.read(), dtype=np.uint8)\
                .astype(np.int32)
        with _open_maybe_gz(os.path.join(self._root, image_file)) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            self._data = data.reshape(n, rows, cols, 1)


class FashionMNIST(MNIST):
    """Same wire format as MNIST (reference datasets.py:FashionMNIST)."""

    def __init__(self,
                 root=os.path.join("~", ".mxnet", "datasets",
                                   "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python/binary batches (reference
    datasets.py:CIFAR10 :125 — binary format: 1 label byte + 3072 image
    bytes per record)."""

    _train_names = ["data_batch_%d.bin" % i for i in range(1, 6)]
    _test_names = ["test_batch.bin"]
    _record_label_bytes = 1

    def __init__(self,
                 root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with _open_maybe_gz(filename) as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        lb = self._record_label_bytes
        rec = raw.reshape(-1, 3072 + lb)
        data = rec[:, lb:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        label = rec[:, lb - 1].astype(np.int32)
        return data, label

    def _get_data(self):
        names = self._train_names if self._train else self._test_names
        # search root and a conventional subdirectory
        candidates = [self._root,
                      os.path.join(self._root, "cifar-10-batches-bin"),
                      os.path.join(self._root, "cifar-100-binary")]
        base = next((c for c in candidates
                     if os.path.exists(os.path.join(c, names[0])) or
                     os.path.exists(os.path.join(c, names[0] + ".gz"))),
                    self._root)
        data, label = zip(*[self._read_batch(os.path.join(base, n))
                            for n in names])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100 binary (2 label bytes: coarse, fine) (reference
    datasets.py:CIFAR100)."""

    _train_names = ["train.bin"]
    _test_names = ["test.bin"]

    def __init__(self,
                 root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._record_label_bytes = 2
        self._fine = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _read_batch(self, filename):
        with _open_maybe_gz(filename) as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3074)
        data = rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        label = rec[:, 1 if self._fine else 0].astype(np.int32)
        return data, label


class ImageRecordDataset(dataset.RecordFileDataset):
    """Images + labels from a RecordIO pack (reference
    datasets.py:ImageRecordDataset :247)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = _image._imdecode_np(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(dataset.Dataset):
    """root/category/image.jpg layout (reference
    datasets.py:ImageFolderDataset :268)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory."
                              % path, stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn(
                        "Ignoring %s of type %s. Only support %s" %
                        (filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        with open(self.items[idx][0], "rb") as f:
            img = _image._imdecode_np(f.read(), self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
