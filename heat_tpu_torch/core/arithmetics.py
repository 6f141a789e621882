"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py):
the ones the KMeans, linear-algebra and Lasso slices use.

``div`` and ``pow`` promote their operands as the JAX package's ``jnp``
operations do (an integer meets a float at the float's type), and true
division of integers gives float64 for 64-bit integers and float32
otherwise, as ``heat_tpu`` gives with x64 on."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["add", "div", "divide", "mul", "neg", "pow", "power", "sub", "sum"]


def add(t1, t2) -> DNDarray:
    """Elementwise addition."""
    return _operations._binary_op(torch.add, t1, t2)


def _subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # torch refuses ``-`` on a bool tensor; jnp subtracts in the promoted type
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.sub(a.to(t), b.to(t))


def sub(t1, t2) -> DNDarray:
    """Elementwise subtraction in the promoted type (two bool operands
    raise, as in ``heat_tpu``)."""
    return _operations._binary_op(_subtract, t1, t2)


def mul(t1, t2) -> DNDarray:
    """Elementwise multiplication."""
    return _operations._binary_op(torch.mul, t1, t2)


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.promote_types(a.dtype, b.dtype)
    if not (t.is_floating_point or t.is_complex):
        t = torch.float64 if t == torch.int64 else torch.float32
    return torch.true_divide(a.to(t), b.to(t))


def div(t1, t2) -> DNDarray:
    """Elementwise true division."""
    return _operations._binary_op(_true_divide, t1, t2)


divide = div


def _power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.promote_types(a.dtype, b.dtype)
    if t == torch.bool:  # jnp.power of two bools is int32
        t = torch.int32
    return torch.pow(a.to(t), b.to(t))


def pow(t1, t2) -> DNDarray:
    """Elementwise power."""
    return _operations._binary_op(_power, t1, t2)


power = pow


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
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = lambda self, other: div(other, self)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = lambda self, other: pow(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.sum = lambda self, axis=None, keepdims=False: sum(self, axis=axis, keepdims=keepdims)
