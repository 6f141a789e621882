"""Data utilities (counterpart of heat_tpu/utils/data/)."""

from . import matrixgallery, mnist, spherical, _utils
from .datatools import DataLoader, Dataset, dataset_irecv, dataset_ishuffle, dataset_shuffle
from .matrixgallery import parter
from .mnist import MNISTDataset
from .partial_dataset import PartialH5Dataset, PartialH5DataLoaderIter
from .spherical import create_spherical_dataset
from ...native import PrefetchPipeline

__all__ = [
    "DataLoader",
    "Dataset",
    "MNISTDataset",
    "mnist",
    "PartialH5Dataset",
    "PartialH5DataLoaderIter",
    "PrefetchPipeline",
    "create_spherical_dataset",
    "dataset_irecv",
    "dataset_ishuffle",
    "dataset_shuffle",
    "matrixgallery",
    "parter",
    "spherical",
]
