"""Exponential and logarithmic functions (counterpart of
heat_tpu/core/exponential.py).  Elementwise, shard by shard; integer and
bool input is cast to float32 first (``square`` keeps its type), as in the
JAX package."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "logaddexp", "logaddexp2", "sqrt", "square", "cbrt"]


def exp(x, out=None) -> DNDarray:
    return _operations._local_op(torch.exp, x, out=out)


def expm1(x, out=None) -> DNDarray:
    return _operations._local_op(torch.expm1, x, out=out)


def exp2(x, out=None) -> DNDarray:
    return _operations._local_op(torch.exp2, x, out=out)


def log(x, out=None) -> DNDarray:
    return _operations._local_op(torch.log, x, out=out)


def log2(x, out=None) -> DNDarray:
    return _operations._local_op(torch.log2, x, out=out)


def log10(x, out=None) -> DNDarray:
    return _operations._local_op(torch.log10, x, out=out)


def log1p(x, out=None) -> DNDarray:
    return _operations._local_op(torch.log1p, x, out=out)


def logaddexp(x1, x2, out=None, where=None) -> DNDarray:
    return _operations._binary_op(_operations._promoted(torch.logaddexp, inexact=True), x1, x2, out=out, where=where)


def logaddexp2(x1, x2, out=None, where=None) -> DNDarray:
    return _operations._binary_op(_operations._promoted(torch.logaddexp2, inexact=True), x1, x2, out=out, where=where)


def sqrt(x, out=None) -> DNDarray:
    """Elementwise non-negative square root."""
    return _operations._local_op(torch.sqrt, x, out=out)


def _square(t: torch.Tensor) -> torch.Tensor:
    # jnp squares a bool to int32
    return torch.square(t.to(torch.int32) if t.dtype == torch.bool else t)


def square(x, out=None) -> DNDarray:
    return _operations._local_op(_square, x, out=out, no_cast=True)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: the real cube root keeps the sign of t
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


def cbrt(x, out=None) -> DNDarray:
    return _operations._local_op(_cbrt, x, out=out)


DNDarray.exp = lambda self, out=None: exp(self, out)
DNDarray.exp2 = lambda self, out=None: exp2(self, out)
DNDarray.expm1 = lambda self, out=None: expm1(self, out)
DNDarray.log = lambda self, out=None: log(self, out)
DNDarray.log2 = lambda self, out=None: log2(self, out)
DNDarray.log10 = lambda self, out=None: log10(self, out)
DNDarray.log1p = lambda self, out=None: log1p(self, out)
DNDarray.sqrt = lambda self, out=None: sqrt(self, out)
DNDarray.square = lambda self, out=None: square(self, out)

# the fusion engine's op table ("elementwise": shape-preserving maps the
# transport engine's fused split tail may replay tile by tile)
for _fn, _name in [
    (torch.exp, "exp"), (torch.exp2, "exp2"), (torch.expm1, "expm1"), (torch.log, "log"),
    (torch.log2, "log2"), (torch.log10, "log10"), (torch.log1p, "log1p"), (torch.sqrt, "sqrt"),
    (_square, "square"), (_cbrt, "cbrt"),
    (_operations._promoted(torch.logaddexp, inexact=True), "logaddexp"),
    (_operations._promoted(torch.logaddexp2, inexact=True), "logaddexp2"),
]:
    _operations.fusion.register_op(_fn, _name, kind="elementwise")
