"""Relational operations (counterpart of heat_tpu/core/relational.py)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray
from ..parallel.sort import ordered_less

__all__ = ["eq", "ge", "gt", "le", "lt", "ne"]


def eq(x, y) -> DNDarray:
    return _operations._binary_op(torch.eq, x, y)


def ne(x, y) -> DNDarray:
    return _operations._binary_op(torch.ne, x, y)


# complex values compare in NumPy's lexicographic order (real parts, then
# imaginary parts), as heat_tpu's do; torch has no complex ordering
def lt(x, y) -> DNDarray:
    return _operations._binary_op(ordered_less, x, y)


def le(x, y) -> DNDarray:
    return _operations._binary_op(lambda a, b: ordered_less(a, b, or_equal=True), x, y)


def gt(x, y) -> DNDarray:
    return _operations._binary_op(lambda a, b: ordered_less(b, a), x, y)


def ge(x, y) -> DNDarray:
    return _operations._binary_op(lambda a, b: ordered_less(b, a, or_equal=True), x, y)


DNDarray.__eq__ = lambda self, other: eq(self, other)
DNDarray.__ne__ = lambda self, other: ne(self, other)
DNDarray.__lt__ = lambda self, other: lt(self, other)
DNDarray.__le__ = lambda self, other: le(self, other)
DNDarray.__gt__ = lambda self, other: gt(self, other)
DNDarray.__ge__ = lambda self, other: ge(self, other)
DNDarray.__hash__ = object.__hash__
