"""Vision datasets, from ``tpu_mx/gluon/data/vision/datasets.py``.

MNIST, FashionMNIST and CIFAR10/100 read the standard files under
``root`` when they are there; nothing is downloaded, and without the
files each is the reference's synthetic stand-in (class prototypes plus
noise, from a fixed seed), so the same call gives the same samples in
both packages.  ``ImageRecordDataset`` decodes an indexed RecordIO file
with OpenCV, ``ImageFolderDataset`` reads a folder per class.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageRecordDataset",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


def _synthetic_images(n, shape, num_classes, seed):
    """Class-separable synthetic images from ``seed``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    protos = rng.uniform(0, 255, (num_classes,) + shape).astype(np.float32)
    imgs = protos[labels] + rng.normal(0, 16, (n,) + shape).astype(np.float32)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


class MNIST(_DownloadedDataset):
    """MNIST's idx-ubyte files (gzip), as ``(28, 28, 1)`` uint8 images
    and int32 labels."""

    _shape = (28, 28, 1)
    _nclass = 10
    _files = {True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
              False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}
    _synthetic_n = {True: 6000, False: 1000}

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_file, lbl_file = self._files[self._train]
        img_path = os.path.join(self._root, img_file)
        lbl_path = os.path.join(self._root, lbl_file)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    n, rows, cols, 1)
        else:
            data, label = _synthetic_images(
                self._synthetic_n[self._train], self._shape, self._nclass,
                seed=42 if self._train else 43)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _nclass = 10
    _synthetic_n = {True: 5000, False: 1000}

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        raw = np.fromfile(filename, dtype=np.uint8).reshape(-1, 3073)
        return raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            raw[:, 0].astype(np.int32)

    def _get_data(self):
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if self._train \
            else ["test_batch.bin"]
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f)
                 for f in files]
        if all(os.path.exists(p) for p in paths):
            parts = [self._read_batch(p) for p in paths]
            self._data = np.concatenate([p[0] for p in parts])
            self._label = np.concatenate([p[1] for p in parts])
        else:
            self._data, self._label = _synthetic_images(
                self._synthetic_n[self._train], self._shape, self._nclass,
                seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _nclass = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        self._data, self._label = _synthetic_images(
            self._synthetic_n[self._train], self._shape,
            self._nclass if self._fine else 20, seed=46 if self._train else 47)


class ImageRecordDataset(Dataset):
    """Images of an indexed RecordIO file, decoded with OpenCV (BGR, as
    the reference)."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import IndexedRecordIO, unpack_img
        self._record = IndexedRecordIO(filename + ".idx", filename, "r")
        self._flag = flag
        self._transform = transform
        self._unpack = unpack_img

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack(record)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """A folder per class under ``root``; ``.jpg``/``.jpeg``/``.png``
    files decoded with Pillow (RGB), ``.npy`` files loaded."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, filename), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            from ....image import imread
            img = imread(path).asnumpy()
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
