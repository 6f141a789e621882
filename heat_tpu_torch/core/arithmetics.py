"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py):
the ones the KMeans slice and the smoke flow use."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["add", "mul", "neg", "sub", "sum"]


def add(t1, t2) -> DNDarray:
    """Elementwise addition."""
    return _operations._binary_op(torch.add, t1, t2)


def sub(t1, t2) -> DNDarray:
    """Elementwise subtraction."""
    return _operations._binary_op(torch.sub, t1, t2)


def mul(t1, t2) -> DNDarray:
    """Elementwise multiplication."""
    return _operations._binary_op(torch.mul, t1, t2)


def neg(a) -> DNDarray:
    """Elementwise negation."""
    return _operations._local_op(torch.neg, a, no_cast=True)


def _sum(t, dim, keepdim):
    return torch.sum(t, dim=dim, keepdim=keepdim)


def sum(a, axis=None, keepdims: bool = False) -> DNDarray:
    """Sum reduction; over the split axis, partial sums are all-reduced."""
    return _operations._reduce_op(_sum, a, axis=axis, keepdims=keepdims, combine="sum")


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(other, self)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = lambda self, other: sub(other, self)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.sum = lambda self, axis=None, keepdims=False: sum(self, axis=axis, keepdims=keepdims)
