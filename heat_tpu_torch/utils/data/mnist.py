"""MNIST (counterpart of heat_tpu/utils/data/mnist.py).

Reads the canonical IDX ubyte files from ``root`` (``train-images-idx3-ubyte``
and ``train-labels-idx1-ubyte``, or the ``t10k-*`` pair, plain or ``.gz``,
flat or in torchvision's ``MNIST/raw/`` layout).  Nothing is downloaded:
without the files and with ``download=True`` it builds the JAX package's
seeded MNIST-shaped stand-in, bit for bit.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Optional

import numpy as np

from ...core import factories
from . import datatools

__all__ = ["MNISTDataset"]

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _find(root: str, name: str) -> Optional[str]:
    for base in (root, os.path.join(root, "MNIST", "raw")):
        for suffix in ("", ".gz"):
            path = os.path.join(base, name + suffix)
            if os.path.exists(path):
                return path
    return None


def _read_idx(path: str) -> np.ndarray:
    """An IDX ubyte file (the MNIST container) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if magic >> 8 != 0x08 or ndim not in (1, 3):
            raise ValueError(f"{path}: not an IDX ubyte file (magic {magic:#x})")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _synthetic(train: bool) -> tuple:
    """The seeded MNIST-shaped stand-in: each sample its class digit as a
    blocky intensity pattern plus noise."""
    n = 512 if train else 128
    rng = np.random.default_rng(28 if train else 10)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    base = rng.integers(0, 50, (10, 28, 28))
    stamps = np.zeros((10, 28, 28), dtype=np.int64)
    for d in range(10):
        stamps[d, 4 + d * 2 : 8 + d * 2, 6:22] = 200
        stamps[d, 8:20, 4 + d : 8 + d] = 180
    images = np.clip(base[labels] + stamps[labels] + rng.integers(0, 30, (n, 28, 28)), 0, 255)
    return images.astype(np.uint8), labels


class MNISTDataset(datatools.Dataset):
    """MNIST as a dataset of split DNDarrays: ``htdata``/``httargets`` are
    the global arrays, ``data``/``targets`` their tensors; a ``test_set``
    stays unsplit and unshuffled."""

    def __init__(
        self,
        root: str,
        train: bool = True,
        transform: Callable = None,
        target_transform: Callable = None,
        download: bool = True,
        split: Optional[int] = 0,
        ishuffle: bool = False,
        test_set: bool = False,
    ):
        if split not in (0, None):
            raise ValueError("split must be 0 or None")
        images_name, labels_name = _FILES[train]
        images_path, labels_path = _find(root, images_name), _find(root, labels_name)
        if images_path is not None and labels_path is not None:
            images, labels = _read_idx(images_path), _read_idx(labels_path)
        elif download:
            images, labels = _synthetic(train)
        else:
            raise FileNotFoundError(f"MNIST IDX files not found under {root!r} and download=False")
        split = split if not test_set else None
        array = factories.array(images, split=split)
        targets = factories.array(labels.astype(np.int64), split=split)
        super().__init__(array, targets)
        self._sample_transform = transform
        self._target_transform = target_transform
        self.test_set = test_set
        self.partial_dataset = False
        self.comm = array.comm
        self.htdata = array
        self.httargets = targets
        self.ishuffle = ishuffle
        if split is not None:
            min_data_split = array.shape[0] // array.comm.size
            self._cut_slice = slice(min_data_split)
            self.lcl_half = min_data_split // 2
        else:
            self._cut_slice = None
            self.lcl_half = array.shape[0] // 2

    @property
    def data(self):
        return self.htdata.larray

    @property
    def targets(self):
        return self.httargets.larray

    def __getitem__(self, index):
        img, target = self.htdata.larray[index], self.httargets.larray[index]
        if self._sample_transform is not None:
            img = self._sample_transform(img)
        if self._target_transform is not None:
            target = self._target_transform(target)
        return img, target

    def __len__(self) -> int:
        return self.htdata.shape[0]

    def Shuffle(self):
        """The epoch shuffle of images and labels together."""
        if not self.test_set:
            self.arrays = (self.htdata, self.httargets)
            datatools.dataset_shuffle(self)
            self.htdata, self.httargets = self.arrays

    def Ishuffle(self):
        """The non-blocking epoch shuffle (the same call)."""
        if not self.test_set:
            self.arrays = (self.htdata, self.httargets)
            datatools.dataset_ishuffle(self)
            self.htdata, self.httargets = self.arrays
