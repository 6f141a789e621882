"""Generic operation machinery (counterpart of heat_tpu/core/_operations.py).

* :func:`_binary_op` — broadcast, pick the result split by the dominance rule
  (a split operand wins over a replicated one; with both split, the first
  operand's split wins), then apply the operation position by position on
  matching blocks of each operand.
* :func:`_local_op` — elementwise, shard by shard.
* :func:`_reduce_op` — a reduction that keeps the split axis runs on each
  shard alone; one over the split axis reduces each shard and then combines
  the partial results across positions.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axes_for_reduction
from ..parallel import collectives

__all__ = ["_binary_op", "_local_op", "_reduce_op"]


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


def _binary_op(operation: Callable, t1, t2) -> DNDarray:
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
    return DNDarray(
        shards, out_shape, types.canonical_heat_type(result.dtype), split, device, comm
    )


def _local_op(operation: Callable, x: DNDarray, no_cast: bool = False) -> DNDarray:
    """Elementwise operation; integer input is cast to float32 first unless
    ``no_cast``."""
    sanitation.sanitize_in(x)

    def apply(t):
        if not no_cast and not (t.is_floating_point() or t.is_complex()):
            t = t.to(torch.float32)
        return operation(t)

    if x.split is None:
        shards = [apply(x.shards[0])] * x.comm.size
    else:
        shards = [apply(s) for s in x.shards]
    return DNDarray(
        shards, x.shape, types.canonical_heat_type(shards[0].dtype), x.split, x.device, x.comm
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


def _reduce_op(fn: Callable, x: DNDarray, axis=None, keepdims: bool = False, combine: str = "sum") -> DNDarray:
    """Generic reduction.  ``fn(t, dim, keepdim)`` reduces one tensor;
    ``combine`` (``"sum"``, ``"min"`` or ``"argmin"``) says how partial
    results over the split axis merge across positions."""
    sanitation.sanitize_in(x)
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    comm = x.comm
    if x.split is None or x.split not in axes:
        if x.split is None:
            shards = [_apply_reduction(fn, x.shards[0], axes, keepdims)] * comm.size
        else:
            shards = [_apply_reduction(fn, s, axes, keepdims) for s in x.shards]
    elif combine == "argmin" and len(axes) > 1:
        # a flat index over several axes, the split one among them: gather
        result = _apply_reduction(fn, x.larray, axes, keepdims)
        shards = [result] * comm.size
    else:
        # the split axis is reduced: reduce each non-empty shard, then merge
        # the partials across positions (an empty shard has no minimum)
        live = [r for r in range(comm.size) if x.shards[r].shape[x.split] > 0]
        if not live:
            result = _apply_reduction(fn, x.larray, axes, keepdims)
        elif combine == "sum":
            result = collectives.psum([_apply_reduction(fn, x.shards[r], axes, keepdims) for r in live])[0]
        elif combine == "min":
            result = collectives.pmin([_apply_reduction(fn, x.shards[r], axes, keepdims) for r in live])[0]
        else:
            result = _argmin_across(x, live, axes[0], keepdims)
        shards = [result] * comm.size
    split = _reduce_split(x.split, axes, keepdims, shards[0].ndim)
    gshape = tuple(shards[0].shape) if split is None else _gshape(x.shape, axes, keepdims)
    return DNDarray(
        shards, gshape, types.canonical_heat_type(shards[0].dtype), split, x.device, x.comm
    )


def _gshape(shape, axes, keepdims: bool):
    if keepdims:
        return tuple(1 if i in axes else n for i, n in enumerate(shape))
    return tuple(n for i, n in enumerate(shape) if i not in axes)


def _argmin_across(x: DNDarray, live, axis: int, keepdims: bool) -> torch.Tensor:
    """Argmin over the split axis: each shard's minimum and its global index,
    merged so that the first minimum along the axis wins; a NaN is the
    minimum, and the first NaN wins (``torch.argmin``, ``jnp.argmin``)."""
    best_v = best_i = None
    for r in live:
        s = x.shards[r]
        off = x.comm.chunk(x.shape, x.split, rank=r)[0]
        v = torch.amin(s, dim=axis, keepdim=keepdims)
        i = torch.argmin(s, dim=axis, keepdim=keepdims) + off
        if best_v is None:
            best_v, best_i = v, i
        else:
            v = v.to(best_v.device)
            take = (v < best_v) | (torch.isnan(v) & ~torch.isnan(best_v))
            best_v = torch.where(take, v, best_v)
            best_i = torch.where(take, i.to(best_i.device), best_i)
    return best_i
