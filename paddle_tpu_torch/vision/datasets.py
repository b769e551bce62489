"""Vision datasets: ``paddle_tpu/vision/datasets.py``, copied.

``FakeData``: seeded synthetic images and labels from
``np.random.RandomState(seed)``, the JAX package's stream bit for bit.
``MNIST`` / ``FashionMNIST`` (idx files, gzipped or not) and
``Cifar10`` / ``Cifar100`` (the python-pickle tarball) read local files
in the reference's on-disk formats; there is no download, and a missing
file raises, as in the JAX package.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional, Tuple

import numpy as np

from ..io.dataset import Dataset

_DEFAULT_ROOT = os.path.expanduser("~/.cache/paddle_tpu/datasets")


class FakeData(Dataset):
    """Deterministic synthetic image classification data."""

    def __init__(self, num_samples: int = 256,
                 image_shape: Tuple[int, ...] = (3, 32, 32),
                 num_classes: int = 10, transform: Optional[Callable] = None,
                 seed: int = 0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        self._images = self._rng.rand(
            num_samples, *self.image_shape).astype(np.float32)
        self._labels = self._rng.randint(
            0, num_classes, (num_samples, 1)).astype(np.int64)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        img = self._images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._labels[idx]


class MNIST(Dataset):
    """MNIST from local idx-format files (image_path/label_path or the
    standard files under ``root``)."""

    NAME = "mnist"
    _FILES = {
        "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = True, backend: str = "cv2",
                 root: Optional[str] = None):
        root = root or os.path.join(_DEFAULT_ROOT, self.NAME)
        img_f, lbl_f = self._FILES[mode]
        image_path = image_path or os.path.join(root, img_f)
        label_path = label_path or os.path.join(root, lbl_f)
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"{self.NAME} files not found at {image_path} / {label_path}"
                " — this environment has no network access; place the "
                "standard idx files there, or use vision.datasets.FakeData")
        self.transform = transform
        self.images = self._read_idx(image_path, 3)
        self.labels = self._read_idx(label_path, 1).astype(np.int64)

    @staticmethod
    def _read_idx(path: str, ndim: int) -> np.ndarray:
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            data = f.read()
        dims = struct.unpack_from(f">{ndim}i", data, 4)
        return np.frombuffer(
            data, np.uint8, offset=4 + 4 * ndim).reshape(dims)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[idx]], np.int64)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """CIFAR-10 from the standard python-pickle tarball under ``root``."""

    _TAR = "cifar-10-python.tar.gz"
    _COARSE = False

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = True,
                 backend: str = "cv2", root: Optional[str] = None):
        root = root or os.path.join(_DEFAULT_ROOT, "cifar")
        data_file = data_file or os.path.join(root, self._TAR)
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"cifar tarball not found at {data_file} — no network "
                "access; place it there or use vision.datasets.FakeData")
        self.transform = transform
        self.images, self.labels = self._load(data_file, mode)

    def _load(self, path, mode):
        imgs, lbls = [], []
        want = "data_batch" if mode == "train" else "test_batch"
        with tarfile.open(path) as tar:
            for m in tar.getmembers():
                if want in m.name:
                    d = pickle.loads(tar.extractfile(m).read(),
                                     encoding="bytes")
                    imgs.append(d[b"data"])
                    lbls.extend(d.get(b"labels", d.get(b"fine_labels")))
        x = np.concatenate(imgs).reshape(-1, 3, 32, 32)
        return x, np.asarray(lbls, np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[idx]], np.int64)


class Cifar100(Cifar10):
    _TAR = "cifar-100-python.tar.gz"
