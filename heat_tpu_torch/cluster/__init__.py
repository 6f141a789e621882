"""Clustering estimators."""

from . import packing
from .convert import kmeans_from_state, spectral_from_state
from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids
from .packing import PackedSamples, load_hdf5_packed, pack, rand_packed, randn_packed
from .spectral import Spectral

__all__ = [
    "KMeans",
    "KMedians",
    "KMedoids",
    "PackedSamples",
    "Spectral",
    "kmeans_from_state",
    "load_hdf5_packed",
    "pack",
    "packing",
    "rand_packed",
    "randn_packed",
    "spectral_from_state",
]
