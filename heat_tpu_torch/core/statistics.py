"""Statistics (counterpart of heat_tpu/core/statistics.py): ``min``,
``argmin`` and ``mean``.  ``torch.argmin``, like ``jnp.argmin``, returns
the first minimum, and the merge across positions keeps that rule."""

from __future__ import annotations

import math

import torch

from . import _operations, sanitation
from .dndarray import DNDarray
from .stride_tricks import sanitize_axes_for_reduction

__all__ = ["argmin", "mean", "min"]


def _float_sum(t, dim, keepdim):
    """Sum in the mean's accumulation type: integers in float32, 16-bit
    floats in float32 (the result is cast back), wider floats as they are."""
    if not (t.is_floating_point() or t.is_complex()) or t.element_size() < 4:
        t = t.to(torch.float32)
    return torch.sum(t, dim=dim, keepdim=keepdim)


def mean(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean (heat_tpu/core/statistics.py:297): integers give
    float32, floats keep their type.  Over the split axis, the positions'
    partial sums are all-reduced and divided by the count once."""
    sanitation.sanitize_in(x)
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    count = math.prod(x.shape[a] for a in axes)
    total = _operations._reduce_op(_float_sum, x, axis=axis, keepdims=keepdims, combine="sum")
    tt = x.dtype.torch_type()
    out_type = tt if (tt.is_floating_point or tt.is_complex) else torch.float32
    return _operations._local_op(lambda t: (t / count).to(out_type), total)


DNDarray.mean = lambda self, axis=None, keepdims=False: mean(self, axis=axis, keepdims=keepdims)


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
