"""Test matrices (counterpart of heat_tpu/utils/data/matrixgallery.py)."""

from __future__ import annotations

from typing import Optional

from ...core import factories, types
from ...core.dndarray import DNDarray

__all__ = ["parter"]


def parter(n: int, split: Optional[int] = None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """The Parter matrix, a Toeplitz matrix whose singular values cluster
    at π: A[i, j] = 1 / (j − i + 0.5), as the JAX package builds it."""
    a = factories.arange(n, dtype=dtype, device=device, comm=comm).larray
    return factories.array(1.0 / (a[None, :] - a[:, None] + 0.5), dtype=dtype, split=split, device=device, comm=comm)
