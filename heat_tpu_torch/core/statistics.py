"""Statistics (counterpart of heat_tpu/core/statistics.py): ``min`` and
``argmin``.  ``torch.argmin``, like ``jnp.argmin``, returns the first
minimum, and the merge across positions keeps that rule."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["argmin", "min"]


def _amin(t, dim, keepdim):
    return torch.amin(t, dim=dim, keepdim=keepdim)


def _argmin(t, dim, keepdim):
    return torch.argmin(t, dim=dim, keepdim=keepdim)


def min(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Minimum."""
    return _operations._reduce_op(_amin, x, axis=axis, keepdims=keepdims, combine="min")


def argmin(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Index of the (first) minimum; ``axis=None`` indexes the flattened array."""
    if axis is not None and not isinstance(axis, int):
        raise TypeError(f"argmin takes one axis or None, got {axis!r}")
    return _operations._reduce_op(_argmin, x, axis=axis, keepdims=keepdims, combine="argmin")
