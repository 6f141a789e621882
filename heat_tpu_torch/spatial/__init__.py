"""Pairwise-distance functions."""

from . import distance
from .distance import cdist, rbf

__all__ = ["cdist", "distance", "rbf"]
