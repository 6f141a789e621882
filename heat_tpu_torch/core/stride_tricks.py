"""Shape and axis helpers (counterpart of heat_tpu/core/stride_tricks.py).
Pure Python; no tensor is touched."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shape(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...]) -> Tuple[int, ...]:
    """NumPy broadcast shape of two operand shapes; raises ``ValueError``."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError:
        raise ValueError(
            f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}"
        )


def broadcast_shapes(*shapes: Tuple[int, ...]) -> Tuple[int, ...]:
    """NumPy broadcast shape of any number of shapes; raises ``ValueError``."""
    try:
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}")


def sanitize_axis(
    shape: Tuple[int, ...], axis: Optional[Union[int, Tuple[int, ...]]]
) -> Optional[Union[int, Tuple[int, ...]]]:
    """Normalize ``axis`` to a non-negative int (or tuple of ints) valid for
    ``shape``; ``None`` passes through."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        axes = tuple(sanitize_axis(shape, int(ax)) for ax in axis)
        if len(set(axes)) != len(axes):
            raise ValueError("duplicate axes given")
        return axes
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0:
        if axis not in (-1, 0):
            raise ValueError(f"axis {axis} is out of bounds for scalar")
        return 0
    if axis < -ndim or axis >= ndim:
        raise ValueError(f"axis {axis} is out of bounds for array of dimension {ndim}")
    return axis % ndim


def sanitize_shape(shape, lval: int = 0) -> Tuple[int, ...]:
    """Normalize a user-supplied shape to a tuple of non-negative ints."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    try:
        shape = tuple(int(dim) for dim in shape)
    except TypeError:
        raise TypeError(f"expected sequence object with length >= 0 or a single integer, got {shape}")
    for dim in shape:
        if dim < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
    return shape


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """``sl`` with start, stop and step resolved against an extent
    ``max_dim`` (``slice.indices``)."""
    if not isinstance(sl, slice):
        raise TypeError("can only be used for slices")
    return slice(*sl.indices(max_dim))


def sanitize_axes_for_reduction(shape: Tuple[int, ...], axis) -> Tuple[Tuple[int, ...], bool]:
    """(tuple of normalized axes, was_none) for a reduction over ``axis``."""
    if axis is None:
        return tuple(range(len(shape))), True
    axis = sanitize_axis(shape, axis)
    if isinstance(axis, int):
        return (axis,), False
    return tuple(axis), False
