"""Relational operations (counterpart of heat_tpu/core/relational.py):
the elementwise comparisons, their NumPy names, and ``equal``, which
returns a Python bool."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations
from .dndarray import DNDarray
from ..parallel.sort import ordered_less

__all__ = ["eq", "equal", "ge", "greater", "greater_equal", "gt", "le", "less", "less_equal", "lt", "ne", "not_equal"]


def eq(x, y) -> DNDarray:
    return _operations._binary_op(torch.eq, x, y)


def equal(x, y) -> bool:
    """True iff the shapes and all elements match (a scalar or a
    broadcastable operand compares elementwise); operands that do not
    broadcast give False."""
    if isinstance(x, DNDarray) and isinstance(y, DNDarray):
        if tuple(x.shape) != tuple(y.shape):
            return False
        return bool(torch.all(x.larray == y.larray.to(x.larray.device)))
    a = x.larray if isinstance(x, DNDarray) else torch.as_tensor(np.asarray(x))
    b = y.larray if isinstance(y, DNDarray) else torch.as_tensor(np.asarray(y))
    try:
        return bool(torch.all(torch.eq(a, b.to(a.device))))
    except RuntimeError:
        return False


def ne(x, y) -> DNDarray:
    return _operations._binary_op(torch.ne, x, y)


not_equal = ne


# complex values compare in NumPy's lexicographic order (real parts, then
# imaginary parts), as heat_tpu's do; torch has no complex ordering
def lt(x, y) -> DNDarray:
    return _operations._binary_op(ordered_less, x, y)


less = lt


def _le(a, b):
    return ordered_less(a, b, or_equal=True)


def _gt(a, b):
    return ordered_less(b, a)


def _ge(a, b):
    return ordered_less(b, a, or_equal=True)


def le(x, y) -> DNDarray:
    return _operations._binary_op(_le, x, y)


less_equal = le


def gt(x, y) -> DNDarray:
    return _operations._binary_op(_gt, x, y)


greater = gt


def ge(x, y) -> DNDarray:
    return _operations._binary_op(_ge, x, y)


greater_equal = ge


DNDarray.__eq__ = lambda self, other: eq(self, other)
DNDarray.__ne__ = lambda self, other: ne(self, other)
DNDarray.__lt__ = lambda self, other: lt(self, other)
DNDarray.__le__ = lambda self, other: le(self, other)
DNDarray.__gt__ = lambda self, other: gt(self, other)
DNDarray.__ge__ = lambda self, other: ge(self, other)
DNDarray.__hash__ = object.__hash__

# the fusion engine's op table: comparisons are elementwise nodes, and the
# ``__bool__`` of their result is a materialization boundary
for _fn, _name in [(torch.eq, "eq"), (torch.ne, "ne"), (ordered_less, "lt"), (_le, "le"), (_gt, "gt"), (_ge, "ge")]:
    _operations.fusion.register_op(_fn, _name, kind="comparison")
