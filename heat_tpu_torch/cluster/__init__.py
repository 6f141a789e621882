"""Clustering estimators."""

from .convert import kmeans_from_state, spectral_from_state
from .kmeans import KMeans
from .spectral import Spectral

__all__ = ["KMeans", "Spectral", "kmeans_from_state", "spectral_from_state"]
