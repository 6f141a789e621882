"""Pairwise-distance functions."""

from . import distance
from .distance import cdist, cdist_quantized, manhattan, rbf

__all__ = ["cdist", "cdist_quantized", "distance", "manhattan", "rbf"]
