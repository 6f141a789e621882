"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py).

Promotion follows the JAX package's ``jnp`` operations: ``div``, ``hypot``
and ``copysign`` promote integers to float (float64 for int64, float32
otherwise, as ``heat_tpu`` gives with x64 on); reductions of integers and
bools give int64; ``cumsum``/``cumprod`` keep the input's type (bool scans
in int64).  16-bit floats reduce in float32 and are cast back once, as the
JAX package accumulates them."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, sanitation, types
from .dndarray import DNDarray, _wrap
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "floordiv",
    "floor_divide",
    "fmod",
    "hypot",
    "invert",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise addition."""
    return _operations._binary_op(torch.add, t1, t2, out=out, where=where)


def _check_int_or_bool(*operands):
    for t in operands:
        if isinstance(t, DNDarray):
            if issubclass(t.dtype, (types.floating, types.complexfloating)):
                raise TypeError(f"expected integer or boolean operand, got {t.dtype.__name__}")
        elif isinstance(t, float):
            raise TypeError("expected integer or boolean operand, got float")


def bitwise_and(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise AND of integer or bool arrays."""
    _check_int_or_bool(t1, t2)
    return _operations._binary_op(_operations._promoted(torch.bitwise_and), t1, t2, out=out, where=where)


def bitwise_or(t1, t2, out=None, where=None) -> DNDarray:
    _check_int_or_bool(t1, t2)
    return _operations._binary_op(_operations._promoted(torch.bitwise_or), t1, t2, out=out, where=where)


def bitwise_xor(t1, t2, out=None, where=None) -> DNDarray:
    _check_int_or_bool(t1, t2)
    return _operations._binary_op(_operations._promoted(torch.bitwise_xor), t1, t2, out=out, where=where)


def bitwise_not(a, out=None) -> DNDarray:
    _check_int_or_bool(a)
    return _operations._local_op(torch.bitwise_not, a, out=out, no_cast=True)


invert = bitwise_not


def copysign(t1, t2, out=None, where=None) -> DNDarray:
    """|t1| with the sign of t2."""
    return _operations._binary_op(_operations._promoted(torch.copysign, inexact=True), t1, t2, out=out, where=where)


def cumprod(a, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis``; along the split axis, each shard
    is scaled by the product of the shards before it."""
    return _operations._cum_op(torch.cumprod, a, axis, combine="prod", dtype=dtype, out=out)


cumproduct = cumprod


def cumsum(a, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``; along the split axis, each shard is
    offset by the sum of the shards before it."""
    return _operations._cum_op(torch.cumsum, a, axis, combine="sum", dtype=dtype, out=out)


def _edge(v, a: DNDarray, axis: int):
    """``prepend``/``append`` as a tensor on ``a``'s device; a scalar
    becomes one slice along ``axis``, typed as jax types a Python scalar
    against ``a``."""
    if v is None:
        return None
    if np.isscalar(v):
        t = torch.tensor(v, dtype=_operations._weak_type(a.dtype.torch_type(), v))
    else:
        t = v.larray if isinstance(v, DNDarray) else torch.as_tensor(np.asarray(v))
    t = t.to(a.shards[0].device)
    if t.ndim == 0:
        shape = list(a.shape)
        shape[axis] = 1
        t = t.expand(shape)
    return t


def diff(a, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """n-th discrete difference along ``axis`` (bool: ``!=``), split like
    ``a``.  Computed on the gathered array: along the split axis each
    difference needs its neighbour's row."""
    sanitation.sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    parts = [p for p in (_edge(prepend, a, axis), a.larray, _edge(append, a, axis)) if p is not None]
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    result = torch.cat([p.to(dt) for p in parts], dim=axis)
    for _ in range(n):
        result = torch.diff(result, dim=axis)
    return _wrap(result, a.split, a.device, a.comm)


def div(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise true division."""
    return _operations._binary_op(_operations._promoted(torch.true_divide, inexact=True), t1, t2, out=out, where=where)


divide = div


def floordiv(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise division rounded toward minus infinity."""
    return _operations._binary_op(_operations._promoted(torch.floor_divide), t1, t2, out=out, where=where)


floor_divide = floordiv


def fmod(t1, t2, out=None, where=None) -> DNDarray:
    """C-style (truncated) remainder, with the sign of the dividend."""
    return _operations._binary_op(_operations._promoted(torch.fmod), t1, t2, out=out, where=where)


def hypot(t1, t2, out=None, where=None) -> DNDarray:
    return _operations._binary_op(_operations._promoted(torch.hypot, inexact=True), t1, t2, out=out, where=where)


def left_shift(t1, t2, out=None, where=None) -> DNDarray:
    _check_int_or_bool(t1)
    return _operations._binary_op(_operations._promoted(torch.bitwise_left_shift), t1, t2, out=out, where=where)


def mod(t1, t2, out=None, where=None) -> DNDarray:
    """Python-style (floored) remainder, with the sign of the divisor."""
    return _operations._binary_op(_operations._promoted(torch.remainder), t1, t2, out=out, where=where)


remainder = mod


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise multiplication."""
    return _operations._binary_op(torch.mul, t1, t2, out=out, where=where)


multiply = mul


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise subtraction in the promoted type (two bool operands
    raise, as in ``heat_tpu``)."""
    # torch refuses ``-`` on bools; jnp subtracts in the promoted type
    return _operations._binary_op(_operations._promoted(torch.sub), t1, t2, out=out, where=where)


subtract = sub


def _power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.promote_types(a.dtype, b.dtype)
    if t == torch.bool:  # jnp.power of two bools is int32
        t = torch.int32
    return torch.pow(a.to(t), b.to(t))


def pow(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise power."""
    return _operations._binary_op(_power, t1, t2, out=out, where=where)


power = pow


def neg(a, out=None) -> DNDarray:
    """Elementwise negation."""
    return _operations._local_op(torch.neg, a, out=out, no_cast=True)


negative = neg


def _positive(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.dtype == torch.bool else torch.positive(t).clone()


def pos(a, out=None) -> DNDarray:
    """Elementwise +a (a copy)."""
    return _operations._local_op(_positive, a, out=out, no_cast=True)


positive = pos


def _dims(dim):
    return (dim,) if isinstance(dim, int) else tuple(sorted(dim, reverse=True))


def _sum(t, dim, keepdim):
    return torch.sum(t, dim=dim, keepdim=keepdim)


def _prod(t, dim, keepdim):
    # torch.prod takes one dim at a time
    for d in _dims(dim):
        t = torch.prod(t, dim=d, keepdim=keepdim)
    return t


def _nan_to(t: torch.Tensor, value: float) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        return t
    return torch.where(torch.isnan(t), torch.full((), value, dtype=t.dtype, device=t.device), t)


def _nansum(t, dim, keepdim):
    return torch.sum(_nan_to(t, 0.0), dim=dim, keepdim=keepdim)


def _nanprod(t, dim, keepdim):
    return _prod(_nan_to(t, 1.0), dim, keepdim)


def _accumulated(fn, a, axis, out, keepdims: bool, combine: str) -> DNDarray:
    """A sum-like reduction; a 16-bit float array reduces in float32 (its
    partials too) and the result is cast back once."""
    sanitation.sanitize_in(a)
    half = a.dtype in (types.float16, types.bfloat16)
    op = (lambda t, dim, keepdim: fn(t.to(torch.float32), dim, keepdim)) if half else fn
    result = _operations._reduce_op(op, a, axis=axis, keepdims=keepdims, combine=combine)
    if half:
        result = result.astype(a.dtype, copy=False)
    return result if out is None else sanitation.sanitize_out(out, result)


def sum(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Sum reduction; over the split axis, partial sums are all-reduced."""
    return _accumulated(_sum, a, axis, out, keepdims, "sum")


def prod(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product reduction; over the split axis, the partial products are
    multiplied across positions."""
    return _accumulated(_prod, a, axis, out, keepdims, "prod")


def nansum(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Sum, NaN counted as 0."""
    return _accumulated(_nansum, a, axis, out, keepdims, "sum")


def nanprod(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product, NaN counted as 1."""
    return _accumulated(_nanprod, a, axis, out, keepdims, "prod")


def right_shift(t1, t2, out=None, where=None) -> DNDarray:
    _check_int_or_bool(t1)
    return _operations._binary_op(_operations._promoted(torch.bitwise_right_shift), t1, t2, out=out, where=where)


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(other, self)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = lambda self, other: sub(other, self)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(other, self)
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = lambda self, other: div(other, self)
DNDarray.__floordiv__ = lambda self, other: floordiv(self, other)
DNDarray.__rfloordiv__ = lambda self, other: floordiv(other, self)
DNDarray.__mod__ = lambda self, other: mod(self, other)
DNDarray.__rmod__ = lambda self, other: mod(other, self)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = lambda self, other: pow(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.__pos__ = lambda self: pos(self)
DNDarray.__invert__ = lambda self: invert(self)
DNDarray.__lshift__ = lambda self, other: left_shift(self, other)
DNDarray.__rshift__ = lambda self, other: right_shift(self, other)
DNDarray.__and__ = lambda self, other: bitwise_and(self, other)
DNDarray.__rand__ = lambda self, other: bitwise_and(other, self)
DNDarray.__or__ = lambda self, other: bitwise_or(self, other)
DNDarray.__ror__ = lambda self, other: bitwise_or(other, self)
DNDarray.__xor__ = lambda self, other: bitwise_xor(self, other)
DNDarray.__rxor__ = lambda self, other: bitwise_xor(other, self)
DNDarray.sum = lambda self, axis=None, out=None, keepdims=False: sum(self, axis=axis, out=out, keepdims=keepdims)
DNDarray.prod = lambda self, axis=None, out=None, keepdims=False: prod(self, axis=axis, out=out, keepdims=keepdims)
DNDarray.cumsum = lambda self, axis, dtype=None, out=None: cumsum(self, axis, dtype, out)
DNDarray.cumprod = lambda self, axis, dtype=None, out=None: cumprod(self, axis, dtype, out)
