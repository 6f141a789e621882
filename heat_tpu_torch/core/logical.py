"""Logical operations (counterpart of heat_tpu/core/logical.py).  ``all``
and ``any`` reduce each shard and merge the partial verdicts across
positions; the predicates are elementwise, shard by shard."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _all(t, dim, keepdim):
    return torch.all(t.to(torch.bool), dim=dim, keepdim=keepdim)


def _any(t, dim, keepdim):
    return torch.any(t.to(torch.bool), dim=dim, keepdim=keepdim)


def all(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """True where every element along ``axis`` is non-zero."""
    return _operations._reduce_op(_all, x, axis=axis, keepdims=keepdims, combine="all", out=out)


def any(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """True where some element along ``axis`` is non-zero."""
    return _operations._reduce_op(_any, x, axis=axis, keepdims=keepdims, combine="any", out=out)


def _operand(v, like=None) -> torch.Tensor:
    if isinstance(v, DNDarray):
        return v.larray
    return torch.as_tensor(np.asarray(v), device=None if like is None else like.device)


def _isclose(rtol: float, atol: float, equal_nan: bool):
    # jnp.isclose compares in the operands' common inexact type
    return _operations._promoted(
        lambda a, b: torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan), inexact=True
    )


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """Whether every pair is close (``isclose``), as a Python bool."""
    a = _operand(x)
    b = _operand(y, a)
    return bool(torch.all(_isclose(rtol, atol, equal_nan)(a, b.to(a.device))))


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """|x − y| <= atol + rtol·|y| elementwise (NumPy's defaults)."""
    return _operations._binary_op(_isclose(rtol, atol, equal_nan), x, y)


def isfinite(x) -> DNDarray:
    return _operations._local_op(torch.isfinite, x, no_cast=True)


def isinf(x) -> DNDarray:
    return _operations._local_op(torch.isinf, x, no_cast=True)


def isnan(x) -> DNDarray:
    return _operations._local_op(torch.isnan, x, no_cast=True)


def isneginf(x, out=None) -> DNDarray:
    return _operations._local_op(torch.isneginf, x, out=out, no_cast=True)


def isposinf(x, out=None) -> DNDarray:
    return _operations._local_op(torch.isposinf, x, out=out, no_cast=True)


def logical_and(x, y) -> DNDarray:
    return _operations._binary_op(torch.logical_and, x, y)


def logical_not(x, out=None) -> DNDarray:
    return _operations._local_op(torch.logical_not, x, out=out, no_cast=True)


def logical_or(x, y) -> DNDarray:
    return _operations._binary_op(torch.logical_or, x, y)


def logical_xor(x, y) -> DNDarray:
    return _operations._binary_op(torch.logical_xor, x, y)


def _signbit(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return torch.zeros_like(t)
    return torch.signbit(t)


def signbit(x, out=None) -> DNDarray:
    return _operations._local_op(_signbit, x, out=out, no_cast=True)


DNDarray.all = lambda self, axis=None, out=None, keepdims=False: all(self, axis, out, keepdims)
DNDarray.any = lambda self, axis=None, out=None, keepdims=False: any(self, axis, out, keepdims)
