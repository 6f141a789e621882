"""Pairwise-distance functions."""

from . import distance
from .distance import cdist, manhattan, rbf

__all__ = ["cdist", "distance", "manhattan", "rbf"]
