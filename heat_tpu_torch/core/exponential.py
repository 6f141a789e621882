"""Exponential and power functions (counterpart of
heat_tpu/core/exponential.py): ``sqrt``.  Integer input is cast to float32
first, as in the JAX package."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["sqrt"]


def sqrt(x) -> DNDarray:
    """Elementwise non-negative square root."""
    return _operations._local_op(torch.sqrt, x)


DNDarray.sqrt = lambda self: sqrt(self)
