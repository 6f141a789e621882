"""Clustering estimators."""

from .convert import kmeans_from_state
from .kmeans import KMeans

__all__ = ["KMeans", "kmeans_from_state"]
