"""Generic operation machinery (counterpart of heat_tpu/core/_operations.py).

* :func:`_binary_op` — broadcast, pick the result split by the dominance rule
  (a split operand wins over a replicated one; with both split, the first
  operand's split wins), then apply the operation position by position on
  matching blocks of each operand.
* :func:`_local_op` — elementwise, shard by shard.
* :func:`_reduce_op` — a reduction that keeps the split axis runs on each
  shard alone; one over the split axis reduces each shard and then combines
  the partial results across positions.
* :func:`_cum_op` — a scan along an axis; along the split axis each shard
  scans alone and then takes the exclusive scan of the totals of the
  shards before it.

``out=`` (every op) and ``where=`` (binary ops) follow the JAX package:
``out`` takes the result's values cast to its dtype and the result's split;
where ``where`` is false, the result holds ``out``'s values, or 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray, _wrap
from .stride_tricks import broadcast_shape, sanitize_axes_for_reduction, sanitize_axis
from ..parallel import collectives

__all__ = ["_binary_op", "_cum_op", "_local_op", "_reduce_op"]


def _as_operand(x, ref: DNDarray):
    """DNDarrays pass through; python scalars become 0-d tensors of the
    scalar-aware ``result_type`` (a scalar never widens the array's dtype);
    other array-likes become replicated tensors on the array's device."""
    tdev = ref.shards[0].device
    if isinstance(x, DNDarray):
        return x
    if np.isscalar(x):
        return torch.tensor(x, dtype=types.result_type(ref.dtype, x).torch_type(), device=tdev)
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=tdev)


def _inexact_type(dtype: torch.dtype) -> torch.dtype:
    """``jnp``'s inexact promotion (x64 on): integers and bools to float32,
    int64 to float64, floats and complex as they are."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32


def _promoted(fn: Callable, inexact: bool = False) -> Callable:
    """``fn`` of two tensors cast to their common type (its inexact form
    with ``inexact``), as ``jnp``'s binary operations promote."""

    def op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = torch.promote_types(a.dtype, b.dtype)
        if inexact:
            t = _inexact_type(t)
        return fn(a.to(t), b.to(t))

    return op


def _weak_type(dtype: torch.dtype, value) -> torch.dtype:
    """The type of ``dtype`` meeting the Python scalar ``value`` under jax's
    weak typing (x64 on): a float scalar keeps a float or complex array's
    type and lifts integers and bools to float64; an int scalar keeps an
    integer array's type and lifts bools to int64; a bool keeps any."""
    if isinstance(value, (bool, np.bool_)):
        return dtype
    if isinstance(value, (float, np.floating)):
        return dtype if (dtype.is_floating_point or dtype.is_complex) else torch.float64
    if isinstance(value, (complex, np.complexfloating)):
        return dtype if dtype.is_complex else torch.complex128
    return torch.int64 if dtype == torch.bool else dtype


def _result_split(s1, s2, nd_out: int, nd1: int, nd2: int) -> Optional[int]:
    """Output split by dominance, mapped through right-aligned broadcasting."""
    if s1 is not None:
        return s1 + (nd_out - nd1)
    if s2 is not None:
        return s2 + (nd_out - nd2)
    return None


def _block(operand, out_shape, split: int, comm, r: int) -> torch.Tensor:
    """The part of ``operand`` that position ``r`` needs to produce its block
    of a result of ``out_shape`` split at ``split``."""
    shape = tuple(operand.shape)
    d = split - (len(out_shape) - len(shape))
    if d < 0 or shape[d] == 1:
        # broadcast along the split dimension: every position needs it all
        return operand.larray if isinstance(operand, DNDarray) else operand
    if isinstance(operand, DNDarray) and operand.split == d:
        return operand.shards[r]
    whole = operand.larray if isinstance(operand, DNDarray) else operand
    off, lshape, _ = comm.chunk(out_shape, split, rank=r)
    return whole.narrow(d, off, lshape[split])


def _finish(result: DNDarray, out: Optional[DNDarray]) -> DNDarray:
    return result if out is None else sanitation.sanitize_out(out, result)


def _masked(result: DNDarray, where, out: Optional[DNDarray]) -> DNDarray:
    """``result`` where ``where`` holds, else ``out``'s values or 0
    (``jnp.where(where, result, out or zeros)``), with ``result``'s split."""
    w = where.larray if isinstance(where, DNDarray) else torch.as_tensor(np.asarray(where))
    r = result.larray
    base = out.larray.to(r.dtype) if out is not None else torch.zeros((), dtype=r.dtype)
    masked = torch.where(w.to(r.device), r, base.to(r.device))
    return _wrap(masked, result.split, result.device, result.comm)


def _binary_op(operation: Callable, t1, t2, out: Optional[DNDarray] = None, where=None) -> DNDarray:
    """Generic distributed binary operation with broadcasting."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")
    ref = t1 if isinstance(t1, DNDarray) else t2
    comm, device = ref.comm, ref.device
    o1, o2 = _as_operand(t1, ref), _as_operand(t2, ref)
    s1 = o1.split if isinstance(o1, DNDarray) else None
    s2 = o2.split if isinstance(o2, DNDarray) else None
    sh1, sh2 = tuple(o1.shape), tuple(o2.shape)
    out_shape = broadcast_shape(sh1, sh2)
    split = _result_split(s1, s2, len(out_shape), len(sh1), len(sh2))
    if split is not None and out_shape[split] <= 1:
        split = None
    if split is None:
        a = o1.larray if isinstance(o1, DNDarray) else o1
        b = o2.larray if isinstance(o2, DNDarray) else o2
        result = operation(a, b)
        shards = [result] * comm.size
    else:
        shards = [
            operation(_block(o1, out_shape, split, comm, r), _block(o2, out_shape, split, comm, r))
            for r in range(comm.size)
        ]
        result = shards[0]
    wrapped = DNDarray(shards, out_shape, types.canonical_heat_type(result.dtype), split, device, comm)
    if where is not None:
        wrapped = _masked(wrapped, where, out)
    return _finish(wrapped, out)


def _local_op(operation: Callable, x: DNDarray, out: Optional[DNDarray] = None, no_cast: bool = False) -> DNDarray:
    """Elementwise operation; integer and bool input is cast to float32
    first unless ``no_cast``."""
    sanitation.sanitize_in(x)

    def apply(t):
        if not no_cast and not (t.is_floating_point() or t.is_complex()):
            t = t.to(torch.float32)
        return operation(t)

    if x.split is None:
        shards = [apply(x.shards[0])] * x.comm.size
    else:
        shards = [apply(s) for s in x.shards]
    return _finish(
        DNDarray(shards, x.shape, types.canonical_heat_type(shards[0].dtype), x.split, x.device, x.comm), out
    )


def _reduce_split(split, axes, keepdims: bool, out_ndim: int):
    if split is not None:
        if split in axes:
            split = None
        elif not keepdims:
            split -= sum(1 for ax in axes if ax < split)
    return None if out_ndim == 0 else split


def _apply_reduction(fn: Callable, t: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
    """``fn(t, dim, keepdim)`` over ``axes``; all axes reduce the flattened
    tensor, as NumPy's ``axis=None`` does."""
    if len(axes) == t.ndim:
        r = fn(t.reshape(-1), 0, False)
        return r.reshape((1,) * t.ndim) if keepdims else r
    return fn(t, axes if len(axes) > 1 else axes[0], keepdims)


def _merge(parts, combine: str) -> torch.Tensor:
    """The partial results of the positions merged into one."""
    if combine == "sum":
        return collectives.psum(parts)[0]
    if combine == "min":
        return collectives.pmin(parts)[0]
    if combine == "max":
        return collectives.pmax(parts)[0]
    out = parts[0]
    for p in parts[1:]:
        p = p.to(out.device)
        if combine == "prod":
            out = out * p
        elif combine == "all":
            out = out & p
        elif combine == "any":
            out = out | p
        else:
            raise ValueError(f"unknown combine {combine!r}")
    return out


def _reduce_op(
    fn: Callable, x: DNDarray, axis=None, keepdims: bool = False, combine: str = "sum", out: Optional[DNDarray] = None
) -> DNDarray:
    """Generic reduction.  ``fn(t, dim, keepdim)`` reduces one tensor;
    ``combine`` (``"sum"``, ``"prod"``, ``"min"``, ``"max"``, ``"all"``,
    ``"any"``, ``"argmin"`` or ``"argmax"``) says how partial results over
    the split axis merge across positions."""
    sanitation.sanitize_in(x)
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    comm = x.comm
    if x.split is None or x.split not in axes:
        if x.split is None:
            shards = [_apply_reduction(fn, x.shards[0], axes, keepdims)] * comm.size
        else:
            shards = [_apply_reduction(fn, s, axes, keepdims) for s in x.shards]
    elif combine in ("argmin", "argmax") and len(axes) > 1:
        # a flat index over several axes, the split one among them: gather
        result = _apply_reduction(fn, x.larray, axes, keepdims)
        shards = [result] * comm.size
    else:
        # the split axis is reduced: reduce each non-empty shard, then merge
        # the partials across positions (an empty shard has no minimum)
        live = [r for r in range(comm.size) if x.shards[r].shape[x.split] > 0]
        if not live:
            result = _apply_reduction(fn, x.larray, axes, keepdims)
        elif combine in ("argmin", "argmax"):
            result = _arg_across(x, live, axes[0], keepdims, largest=combine == "argmax")
        else:
            result = _merge([_apply_reduction(fn, x.shards[r], axes, keepdims) for r in live], combine)
        shards = [result] * comm.size
    split = _reduce_split(x.split, axes, keepdims, shards[0].ndim)
    gshape = tuple(shards[0].shape) if split is None else _gshape(x.shape, axes, keepdims)
    return _finish(
        DNDarray(shards, gshape, types.canonical_heat_type(shards[0].dtype), split, x.device, x.comm), out
    )


def _gshape(shape, axes, keepdims: bool):
    if keepdims:
        return tuple(1 if i in axes else n for i, n in enumerate(shape))
    return tuple(n for i, n in enumerate(shape) if i not in axes)


def _arg_across(x: DNDarray, live, axis: int, keepdims: bool, largest: bool = False) -> torch.Tensor:
    """Argmin (argmax with ``largest``) over the split axis: each shard's
    extremum and its global index, merged so that the first extremum along
    the axis wins; a NaN is both the minimum and the maximum, and the first
    NaN wins (``torch.argmin``/``argmax``, ``jnp.argmin``/``argmax``)."""
    pick, extreme, better = (
        (torch.argmax, torch.amax, torch.gt) if largest else (torch.argmin, torch.amin, torch.lt)
    )
    best_v = best_i = None
    for r in live:
        s = x.shards[r]
        if s.dtype == torch.bool:
            s = s.to(torch.uint8)
        off = x.comm.chunk(x.shape, x.split, rank=r)[0]
        v = extreme(s, dim=axis, keepdim=keepdims)
        i = pick(s, dim=axis, keepdim=keepdims) + off
        if best_v is None:
            best_v, best_i = v, i
        else:
            v = v.to(best_v.device)
            take = better(v, best_v) | (torch.isnan(v) & ~torch.isnan(best_v))
            best_v = torch.where(take, v, best_v)
            best_i = torch.where(take, i.to(best_i.device), best_i)
    return best_i


def _cum_op(
    fn: Callable, x: DNDarray, axis: int, combine: str = "sum", dtype=None, out: Optional[DNDarray] = None
) -> DNDarray:
    """Scan ``fn(t, dim)`` (``torch.cumsum``/``cumprod``) along ``axis``.
    Along the split axis each shard scans alone, then combines with the
    exclusive scan of the last rows of the shards before it (their sum, or
    their product with ``combine="prod"``).  The result keeps the input's
    dtype, as ``jnp.cumsum``'s does, except that bool scans in int64;
    ``dtype`` casts the input first."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative ops require an axis")
    shards = x.shards if x.split is not None else x.shards[:1]
    if dtype is not None:
        shards = [s.to(types.canonical_heat_type(dtype).torch_type()) for s in shards]
    keep = torch.int64 if shards[0].dtype == torch.bool else shards[0].dtype
    scanned = [fn(s, axis).to(keep) for s in shards]
    if x.split == axis and len(scanned) > 1:
        run = None
        for r, sc in enumerate(scanned):
            if sc.shape[axis] == 0:
                continue
            if run is not None:
                scanned[r] = (sc + run if combine == "sum" else sc * run).to(keep)
            run = scanned[r].narrow(axis, sc.shape[axis] - 1, 1)
    if x.split is None:
        scanned = scanned * x.comm.size
    return _finish(
        DNDarray(scanned, x.shape, types.canonical_heat_type(keep), x.split, x.device, x.comm), out
    )
