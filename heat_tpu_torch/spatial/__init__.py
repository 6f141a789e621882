"""Pairwise-distance functions."""

from . import distance
from .distance import cdist

__all__ = ["cdist", "distance"]
