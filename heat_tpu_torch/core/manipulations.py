"""Shape manipulations (counterpart of heat_tpu/core/manipulations.py):
``reshape``, ``resplit`` and ``concatenate``, over the shard list.

A reshape or resplit between split layouts runs through the transport
engine (:mod:`heat_tpu_torch.parallel.transport`), which assembles each
destination shard from the source shards without gathering the array; a
split-crossing reshape writes each destination shard with the repack
kernel (K7).  Shapes the engine refuses, and moves to or from a replicated
layout, gather and cut anew, where the JAX package takes ``jnp.reshape`` or
``device_put``.  ``concatenate`` joins position by position when every
operand is split off the joined axis, and gathers otherwise.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import sanitation, stride_tricks, types
from ..parallel import collectives, transport
from ..parallel.sort import (
    distributed_sort,
    distributed_topk,
    searchsorted_left,
    stable_sort,
    topk_order,
    unique_compact_sorted,
)
from .dndarray import DNDarray, _wrap

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "dstack",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "mpi_topk",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unique",
    "vsplit",
    "vstack",
]


def _torch_dtype(a) -> torch.dtype:
    return a.dtype.torch_type() if isinstance(a, DNDarray) else torch.as_tensor(a).dtype


def reshape(a: DNDarray, *shape, new_split=None) -> DNDarray:
    """Reshape (heat_tpu/core/manipulations.py:288).  ``new_split`` sets the
    result's split; by default it keeps the input's split where the new
    shape has that dimension, else 0 for a split input.

    Split input to split output goes through the transport engine wherever
    :func:`transport.reshape_applicable` takes the shapes, the same test the
    JAX package makes: a reshape that keeps the split dimension and
    everything before it reshapes each shard; any other runs resplit to 0,
    the rechunk (one K7 launch per destination position with rows) and
    resplit to the target.  Other shapes gather and cut anew."""
    sanitation.sanitize_in(a)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = stride_tricks.sanitize_shape(shape, lval=-1)
    known = [d for d in shape if d != -1]
    n_unknown = len(shape) - len(known)
    prod = math.prod(known)
    if n_unknown > 1:
        raise ValueError("can only specify one unknown dimension")
    if (n_unknown == 0 and prod != a.size) or (n_unknown == 1 and (prod == 0 or a.size % prod)):
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    gout = tuple(a.size // prod if d == -1 else int(d) for d in shape)
    if new_split is None:
        new_split = None if a.split is None else (a.split if a.split < len(gout) else 0)
    new_split = stride_tricks.sanitize_axis(gout, new_split) if gout else None
    if (
        a.split is not None
        and new_split is not None
        and transport.reshape_applicable(a.shape, a.split, gout, new_split, a.comm)
    ):
        shards = transport.tiled_reshape(a.shards, a.shape, a.split, gout, new_split, a.comm)
        return DNDarray(shards, gout, a.dtype, new_split, a.device, a.comm)
    return _wrap(a.larray.reshape(gout), new_split, a.device, a.comm)


def resplit(arr: DNDarray, axis=None) -> DNDarray:
    """Out-of-place re-partition (heat_tpu/core/manipulations.py:369).
    Axis-to-axis moves run through :func:`transport.tiled_resplit`; the
    input keeps its shards.  Moves to or from ``split=None`` gather and cut
    anew."""
    sanitation.sanitize_in(arr)
    return arr.resplit(axis)


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis (heat_tpu/core/manipulations.py:123).
    The first split operand's split is the result's."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("need at least one array to concatenate")
    ref = next((a for a in arrays if isinstance(a, DNDarray)), None)
    if ref is None:
        raise TypeError("concatenate needs at least one DNDarray")
    axis = stride_tricks.sanitize_axis(ref.shape, axis)
    for a in arrays[1:]:
        shp = tuple(a.shape)
        if len(shp) != ref.ndim or any(shp[d] != ref.shape[d] for d in range(ref.ndim) if d != axis):
            raise ValueError(
                "all input array dimensions except the concatenation axis must match: "
                f"{ref.shape} vs {shp} on axis {axis}"
            )
    split = next((a.split for a in arrays if isinstance(a, DNDarray) and a.split is not None), None)
    # promotion as jnp.concatenate's: an integer meets a float at the float
    dtype = functools.reduce(torch.promote_types, [_torch_dtype(a) for a in arrays])
    gshape = list(ref.shape)
    gshape[axis] = sum(a.shape[axis] for a in arrays)
    if (
        split is not None
        and split != axis
        and all(isinstance(a, DNDarray) and a.split == split for a in arrays)
    ):
        # split off the joined axis: the shards line up position by position
        shards = [
            torch.cat([a.shards[r].to(dtype) for a in arrays], dim=axis) for r in range(ref.comm.size)
        ]
        return DNDarray(shards, tuple(gshape), types.canonical_heat_type(dtype), split, ref.device, ref.comm)
    tdev = ref.shards[0].device
    parts = [
        (a.larray if isinstance(a, DNDarray) else torch.as_tensor(a, device=tdev)).to(dtype)
        for a in arrays
    ]
    return _wrap(torch.cat(parts, dim=axis), split, ref.device, ref.comm)


# ---------------------------------------------------------------------------
# The rest of the manipulations (heat_tpu/core/manipulations.py).  Each keeps
# the JAX package's rule for the result's split.  Where an operation leaves
# the split dimension's extent alone, every position works on its own shard;
# where it reorders, pads or repeats along the split dimension it meets the
# gathered array, which is cut anew, as ``jnp`` meets the global array there.


def _like(a: DNDarray, fn, gshape, split) -> DNDarray:
    """``fn`` applied to each of ``a``'s shards (once for a replicated
    array); the result has global shape ``gshape`` and split ``split``."""
    if a.split is None:
        t = fn(a.shards[0])
        return DNDarray([t] * a.comm.size, tuple(gshape), types.canonical_heat_type(t.dtype), None, a.device, a.comm)
    shards = [fn(s) for s in a.shards]
    return DNDarray(shards, tuple(gshape), types.canonical_heat_type(shards[0].dtype), split, a.device, a.comm)


def _gathered(a: DNDarray, result: torch.Tensor, split) -> DNDarray:
    return _wrap(result, split if result.ndim else None, a.device, a.comm)


def _axes(shape, axis) -> tuple:
    axes = range(len(shape)) if axis is None else (axis if isinstance(axis, (tuple, list)) else (axis,))
    return tuple(stride_tricks.sanitize_axis(shape, int(d)) for d in axes)


def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """Out-of-place balance (heat_tpu/core/manipulations.py:88): the chunk
    rule's layout is always balanced, so this is the array or its copy."""
    sanitation.sanitize_in(array)
    return _like(array, torch.clone, array.shape, array.split) if copy else array


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """Out-of-place redistribute (heat_tpu/core/manipulations.py:269): a
    copy in the chunk rule's layout, which every array already has."""
    sanitation.sanitize_in(arr)
    return _like(arr, torch.clone, arr.shape, arr.split)


def shape(a: DNDarray):
    """The global shape (heat_tpu/core/manipulations.py:420)."""
    return a.shape


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert an axis of extent 1 (heat_tpu/core/manipulations.py:174),
    per shard."""
    sanitation.sanitize_in(a)
    axis = stride_tricks.sanitize_axis(tuple(a.shape) + (1,), axis)
    split = a.split + 1 if a.split is not None and a.split >= axis else a.split
    gshape = a.shape[:axis] + (1,) + a.shape[axis:]
    return _like(a, lambda s: s.unsqueeze(axis), gshape, split)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """Remove axes of extent 1 (heat_tpu/core/manipulations.py:523): per
    shard, unless the split axis itself goes, which leaves a replicated
    result."""
    sanitation.sanitize_in(x)
    removed = [i for i in range(x.ndim) if x.shape[i] == 1] if axis is None else list(_axes(x.shape, axis))
    for d in removed:
        if x.shape[d] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which has size not equal to one: axis {d}")
    gshape = tuple(e for i, e in enumerate(x.shape) if i not in removed)
    dims = tuple(removed)
    if x.split is not None and x.split in removed:
        return _gathered(x, x.larray.squeeze(dims) if dims else x.larray, None)
    split = None if x.split is None else x.split - sum(1 for r in removed if r < x.split)
    return _like(x, lambda s: s.squeeze(dims) if dims else s, gshape, split)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Interchange two axes (heat_tpu/core/manipulations.py:557), per shard;
    the split follows its axis."""
    sanitation.sanitize_in(x)
    a1, a2 = axis1 % x.ndim, axis2 % x.ndim
    split = a2 if x.split == a1 else a1 if x.split == a2 else x.split
    gshape = list(x.shape)
    gshape[a1], gshape[a2] = gshape[a2], gshape[a1]
    return _like(x, lambda s: s.transpose(a1, a2), gshape, split)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Move axes to new positions (heat_tpu/core/manipulations.py:238), per
    shard; the split follows its axis."""
    sanitation.sanitize_in(x)
    src = [source] if isinstance(source, int) else list(source)
    dst = [destination] if isinstance(destination, int) else list(destination)
    if len(src) != len(dst):
        raise ValueError("`source` and `destination` arguments must have the same number of elements")
    src = [s % x.ndim for s in src]
    dst = [d % x.ndim for d in dst]
    order = [n for n in range(x.ndim) if n not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    split = None if x.split is None else order.index(x.split)
    gshape = tuple(x.shape[o] for o in order)
    return _like(x, lambda s: s.permute(order), gshape, split)


def flatten(a: DNDarray) -> DNDarray:
    """A 1-D copy in row-major order (heat_tpu/core/manipulations.py:185):
    a split array is reshaped to ``(size,)`` split 0 through the transport
    engine, as :func:`reshape` does."""
    sanitation.sanitize_in(a)
    if a.split is None:
        return _like(a, lambda s: s.reshape(-1), (a.size,), None)
    return reshape(a, (a.size,), new_split=0)


def ravel(a: DNDarray) -> DNDarray:
    """Flatten (heat_tpu/core/manipulations.py:264)."""
    return flatten(a)


def flip(a: DNDarray, axis=None) -> DNDarray:
    """Reverse the order along ``axis`` (heat_tpu/core/manipulations.py:193):
    per shard when the split axis is not flipped, else on the gathered
    array; the split is kept."""
    sanitation.sanitize_in(a)
    if a.ndim == 0:
        return _like(a, torch.clone, a.shape, None)
    dims = _axes(a.shape, axis)
    if a.split is not None and a.split in dims:
        return _gathered(a, torch.flip(a.larray, dims), a.split)
    return _like(a, lambda s: torch.flip(s, dims), a.shape, a.split)


def fliplr(a: DNDarray) -> DNDarray:
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    return flip(a, 0)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Circular shift (heat_tpu/core/manipulations.py:394): per shard along
    axes other than the split axis, else on the gathered array (``axis=None``
    rolls the flattened array); the split is kept."""
    sanitation.sanitize_in(x)
    if axis is None:
        return _gathered(x, torch.roll(x.larray, shift), x.split)
    dims = _axes(x.shape, axis)
    shifts = tuple(shift) if isinstance(shift, (tuple, list)) else (shift,) * len(dims)
    if x.split is not None and x.split in dims:
        return _gathered(x, torch.roll(x.larray, shifts, dims), x.split)
    return _like(x, lambda s: torch.roll(s, shifts, dims), x.shape, x.split)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotate by 90° ``k`` times in the plane of ``axes``
    (heat_tpu/core/manipulations.py:402), as NumPy composes it from
    :func:`flip` and :func:`swapaxes`."""
    sanitation.sanitize_in(m)
    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2.")
    if m.ndim < 2:
        raise ValueError(f"rot90 needs at least 2 dimensions, got {m.ndim}")
    a0, a1 = axes[0] % m.ndim, axes[1] % m.ndim
    if a0 == a1:
        raise ValueError("Axes must be different.")
    k %= 4
    if k == 0:
        return _like(m, torch.clone, m.shape, m.split)
    if k == 2:
        return flip(m, (a0, a1))
    if k == 1:
        return swapaxes(flip(m, a1), a0, a1)
    return flip(swapaxes(m, a0, a1), a1)


def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """Broadcast to ``shape`` (heat_tpu/core/manipulations.py:103): per
    shard when the split axis keeps its extent, else on the gathered
    array; the split moves with the added leading axes."""
    sanitation.sanitize_in(x)
    shape = stride_tricks.sanitize_shape(shape)
    if len(shape) < x.ndim or any(
        e != t and e != 1 for e, t in zip(x.shape, shape[len(shape) - x.ndim :])
    ):
        raise ValueError(f"cannot broadcast shape {x.shape} to {shape}")
    split = None if x.split is None else x.split + (len(shape) - x.ndim)
    if x.split is not None and x.shape[x.split] != shape[split]:
        return _gathered(x, torch.broadcast_to(x.larray, shape).contiguous(), split)

    def local(s):
        ls = list(shape)
        if split is not None:
            ls[split] = s.shape[x.split]
        return s.broadcast_to(ls).contiguous()

    return _like(x, local, shape, split)


def broadcast_arrays(*arrays: DNDarray):
    """Broadcast arrays against each other
    (heat_tpu/core/manipulations.py:96)."""
    target = ()
    for a in arrays:
        target = stride_tricks.broadcast_shape(target, a.shape)
    return [broadcast_to(a, target) for a in arrays]


def tile(x: DNDarray, reps) -> DNDarray:
    """Repeat the whole array ``reps`` times per axis
    (heat_tpu/core/manipulations.py:570): per shard when the split axis is
    tiled once, else on the gathered array."""
    sanitation.sanitize_in(x)
    reps = (int(reps),) if isinstance(reps, (int,)) else tuple(int(r) for r in reps)
    nd = max(len(reps), x.ndim)
    reps_full = (1,) * (nd - len(reps)) + reps
    lead = nd - x.ndim
    split = None if x.split is None else x.split + lead
    gshape = tuple(r * e for r, e in zip(reps_full, (1,) * lead + tuple(x.shape)))
    if split is not None and reps_full[split] != 1:
        return _gathered(x, torch.tile(x.larray, reps), split)
    return _like(x, lambda s: torch.tile(s, reps), gshape, split)


def repeat(a: DNDarray, repeats, axis=None) -> DNDarray:
    """Repeat each element (heat_tpu/core/manipulations.py:278): per shard
    along an axis other than the split axis with one count for all,
    else on the gathered array.  ``axis=None`` flattens; a split input then
    gives a split-0 result."""
    sanitation.sanitize_in(a)
    r = repeats.larray if isinstance(repeats, DNDarray) else repeats
    tdev = a.shards[0].device
    if isinstance(r, (list, tuple, np.ndarray)):
        r = torch.as_tensor(np.asarray(r), device=tdev)
    if axis is None:
        split = 0 if a.split is not None else None
        return _gathered(a, torch.repeat_interleave(a.larray.reshape(-1), r), split)
    axis = stride_tricks.sanitize_axis(a.shape, axis)
    scalar = not isinstance(r, torch.Tensor) or r.numel() == 1
    if a.split is None or axis == a.split or not scalar:
        return _gathered(a, torch.repeat_interleave(a.larray, r, dim=axis), a.split)
    n = int(r)
    gshape = tuple(e * n if d == axis else e for d, e in enumerate(a.shape))
    return _like(a, lambda s: torch.repeat_interleave(s, n, dim=axis), gshape, a.split)


_PAD_MODES = ("constant", "edge", "empty", "linear_ramp", "maximum", "mean", "median", "minimum", "reflect",
              "symmetric", "wrap")


def _pad_index(n: int, i: np.ndarray, mode: str) -> np.ndarray:
    """Source index along the axis of the padded positions ``i`` (relative
    to the array's first element) in an index mode, as ``jnp.pad`` builds
    them (its repeated reflections and wraps are periodic in the source)."""
    if mode == "edge" or n == 1:
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        period = 2 * (n - 1)
        m = i % period
        return np.where(m < n, m, period - m)
    period = 2 * n  # symmetric
    m = i % period
    return np.where(m < n, m, period - 1 - m)


# jax's inexact type of each integer type (dtypes._dtype_to_inexact)
_INEXACT = {torch.int64: torch.float64, torch.uint64: torch.float64}


def _ramp(edge: torch.Tensor, num: int, axis: int, reverse: bool) -> torch.Tensor:
    """``linear_ramp``'s padding: ``jnp.linspace(0, edge, num,
    endpoint=False, axis=axis)`` of the edge slice (extent 1 along
    ``axis``) in its type, reversed for the far side.  That is
    ``0·(1 − step) + edge·step`` with ``step = i · (1/num)`` in jax's inexact
    type (float32 for integers up to 32 bits, float64 for 64 bits), floored
    for integers."""
    tt = edge.dtype
    ct = tt if (tt.is_floating_point or tt.is_complex) else _INEXACT.get(tt, torch.float32)
    shape = [1] * edge.ndim
    shape[axis] = num
    stop = edge.to(ct)
    start = torch.zeros((), dtype=ct, device=edge.device)
    if num == 1:
        out = torch.zeros_like(stop)
    else:
        real = ct.to_real() if ct.is_complex else ct
        # XLA folds the division by the constant num into a product with
        # its reciprocal; so does this, for integer ramps floored alike
        recip = torch.ones((), dtype=real, device=edge.device) / num
        step = torch.arange(num, dtype=real, device=edge.device) * recip
        step = step.to(ct).reshape(shape)
        out = start * (1 - step) + stop * step
    if not (tt.is_floating_point or tt.is_complex):
        out = torch.floor(out)
    out = out.to(tt)
    return out.flip(axis) if reverse else out


def _finish_stat(stat: torch.Tensor, tt: torch.dtype) -> torch.Tensor:
    if not (tt.is_floating_point or tt.is_complex):
        stat = torch.round(stat)
    return stat.to(tt)


def _stat_local(t: torch.Tensor, axis: int, mode: str) -> torch.Tensor:
    """The statistic of a stat mode over ``t``'s whole ``axis`` (kept with
    extent 1), rounded and cast back for integers, as ``jnp.pad`` fills."""
    if t.numel() == 0:
        return t.new_zeros(tuple(1 if d == axis else e for d, e in enumerate(t.shape)))
    if mode == "maximum":
        return torch.amax(t, dim=axis, keepdim=True)
    if mode == "minimum":
        return torch.amin(t, dim=axis, keepdim=True)
    if mode == "mean":
        acc = t.dtype if (t.dtype.is_floating_point or t.dtype.is_complex) else torch.float64
        return _finish_stat(torch.mean(t.to(acc), dim=axis, keepdim=True), t.dtype)
    # jnp.median: the midpoint of the middle pair
    ft = t if t.dtype in (torch.float32, torch.float64) else t.to(torch.float64)
    return _finish_stat(torch.quantile(ft, 0.5, dim=axis, keepdim=True, interpolation="midpoint"), t.dtype)


def _stat_split(x: DNDarray, axis: int, mode: str) -> torch.Tensor:
    """:func:`_stat_local` along the split axis of a distributed array: the
    positions' partial extremes or sums all-reduced, the median by the
    distributed selection."""
    from . import statistics

    tt = x.dtype.torch_type()
    if mode in ("maximum", "minimum"):
        red = torch.amax if mode == "maximum" else torch.amin
        parts = [red(s, dim=axis, keepdim=True) for s in x.shards if s.shape[axis]]
        return (collectives.pmax if mode == "maximum" else collectives.pmin)(parts)[0]
    if mode == "mean":
        acc = tt if (tt.is_floating_point or tt.is_complex) else torch.float64
        total = collectives.psum([torch.sum(s.to(acc), dim=axis, keepdim=True) for s in x.shards])[0]
        return _finish_stat(total / x.shape[axis], tt)
    return _finish_stat(statistics.median(x, axis=axis, keepdims=True).shards[0], tt)


_STAT_MODES = ("maximum", "mean", "median", "minimum")


class _PadPlan:
    """What fills the padding of one axis: :meth:`piece` gives the padded
    axis's positions [lo, hi) that lie in the padding, read from ``src``
    (a tensor holding the whole axis, or a ``transport.RowSource`` over the
    shards); ``fill`` is the side's ramps or the statistic."""

    def __init__(self, n: int, axis: int, before: int, after: int, mode: str, const):
        self.axis, self.before, self.after, self.mode, self.const, self.n = axis, before, after, mode, const, n

    def fill(self, first: torch.Tensor, last: torch.Tensor, stat):
        if self.mode == "linear_ramp":
            return _ramp(first, self.before, self.axis, False), _ramp(last, self.after, self.axis, True)
        return stat

    def piece(self, src, like: torch.Tensor, lo: int, hi: int, fill) -> torch.Tensor:
        ax = self.axis
        shape = list(like.shape)
        shape[ax] = hi - lo
        if hi <= lo:
            return like.new_empty(shape)
        if self.mode in ("constant", "empty"):
            c = self.const[0] if lo < self.before else self.const[1]
            return like.new_empty(shape).fill_(torch.tensor(c).to(like.dtype))
        if self.mode in _STAT_MODES:
            return fill.to(like.device).expand(shape)
        if self.mode in ("edge", "reflect", "symmetric", "wrap"):
            idx = torch.as_tensor(_pad_index(self.n, np.arange(lo, hi) - self.before, self.mode), device=like.device)
            return src.take(idx) if isinstance(src, transport.RowSource) else src.index_select(ax, idx)
        if lo < self.before:
            return fill[0].narrow(ax, lo, hi - lo)
        return fill[1].narrow(ax, lo - self.before - self.n, hi - lo)


def _pad_tensor(t: torch.Tensor, plan: _PadPlan) -> torch.Tensor:
    """One tensor holding the whole axis, padded along it."""
    ax, b, n = plan.axis, plan.before, plan.n
    stat = _stat_local(t, ax, plan.mode) if plan.mode in _STAT_MODES else None
    fill = plan.fill(t.narrow(ax, 0, 1), t.narrow(ax, n - 1, 1), stat) if n else None
    parts = [plan.piece(t, t, 0, b, fill), t, plan.piece(t, t, b + n, b + n + plan.after, fill)]
    return torch.cat(parts, dim=ax)


def _pad_split_axis(x: DNDarray, plan: _PadPlan) -> DNDarray:
    """Padding along the split axis of a distributed array: each new shard
    (the chunk rule over the padded length) is written from the body rows
    and edge rows of the positions that own them, never a gathered copy."""
    ax, b, n = plan.axis, plan.before, plan.n
    length = n + b + plan.after
    src = transport.RowSource(ax, n, shards=x.shards)
    stat = _stat_split(x, ax, plan.mode) if plan.mode in _STAT_MODES else None
    fill = plan.fill(src.range(0, 1), src.range(n - 1, n), stat) if n else None
    shards = []
    for r in range(x.comm.size):
        o0 = x.comm.chunk((length,), 0, rank=r)[0]
        o1 = o0 + x.comm.chunk((length,), 0, rank=r)[1][0]
        shape = list(x.shards[0].shape)
        shape[ax] = o1 - o0
        block = x.shards[0].new_empty(shape)
        for lo, hi in ((o0, min(o1, b)), (max(o0, b + n), o1)):
            if lo < hi:
                block.narrow(ax, lo - o0, hi - lo).copy_(plan.piece(src, block, lo, hi, fill))
        # the body, each source shard's rows copied into place
        for s, (s0, s1) in zip(x.shards, src.bounds):
            lo, hi = max(o0, b + s0), min(o1, b + s1)
            if lo < hi:
                block.narrow(ax, lo - o0, hi - lo).copy_(s.narrow(ax, lo - b - s0, hi - lo))
        shards.append(block)
    gshape = tuple(length if d == ax else e for d, e in enumerate(x.shape))
    return DNDarray(shards, gshape, x.dtype, x.split, x.device, x.comm)


def _pad_callable(array: DNDarray, widths: np.ndarray, fn) -> DNDarray:
    """``jnp.pad`` with a callable mode: zero padding, then ``fn(row,
    (before, after), axis, {})`` on every 1-D slice along each axis in
    turn, on the gathered array."""
    t = array.larray
    t = torch.nn.functional.pad(t, [int(v) for d in reversed(range(t.ndim)) for v in widths[d]])
    for axis in range(t.ndim):
        moved = t.movedim(axis, -1)
        rows = moved.reshape(-1, moved.shape[-1])
        done = [torch.as_tensor(fn(row, tuple(int(v) for v in widths[axis]), axis, {})) for row in rows]
        out = torch.stack(done) if done else rows
        t = out.to(t.dtype).reshape(moved.shape).movedim(-1, axis)
    return _gathered(array, t, array.split)


def pad(array: DNDarray, pad_width, mode="constant", constant_values=0) -> DNDarray:
    """Pad an array (heat_tpu/core/manipulations.py:256) in any mode
    ``jnp.pad`` takes: ``constant`` (``constant_values`` a scalar, a
    (before, after) pair or one pair per axis), ``edge``, ``wrap``,
    ``reflect``, ``symmetric``, ``linear_ramp`` (to 0), ``maximum``,
    ``mean``, ``median``, ``minimum`` (over the whole axis), ``empty``
    (zeros), or a callable.  The options other than ``constant_values``
    take ``jnp.pad``'s defaults, as the JAX package passes none.  Axes are
    padded in order, each on the already padded array; the split is kept.
    Along a non-split axis every position pads its own shard; along the
    split axis each new shard is written from the positions that own the
    rows it needs (edge rows included)."""
    sanitation.sanitize_in(array)
    nd = array.ndim
    widths = np.asarray(pad_width)
    if widths.dtype.kind not in "iu":
        raise TypeError("`pad_width` must be of integral type.")
    widths = np.broadcast_to(widths.astype(np.int64), (nd, 2)) if nd else widths.reshape(0, 2)
    if (widths < 0).any():
        raise ValueError("index can't contain negative values")
    if nd == 0:
        return array
    if callable(mode):
        return _pad_callable(array, widths, mode)
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"Unimplemented padding mode '{mode}' for np.pad.")
    consts = np.broadcast_to(np.asarray(constant_values if mode == "constant" else 0), (nd, 2))
    out = array
    for axis in range(nd):
        before, after = int(widths[axis, 0]), int(widths[axis, 1])
        if before == after == 0:
            continue
        if out.shape[axis] == 0 and mode not in ("constant", "empty"):
            raise ValueError(f"can't extend empty axis {axis} using modes other than 'constant' or 'empty'")
        plan = _PadPlan(out.shape[axis], axis, before, after, mode, tuple(consts[axis].tolist()))
        if out.split == axis and out.is_distributed():
            out = _pad_split_axis(out, plan)
        else:
            gshape = tuple(e + before + after if d == axis else e for d, e in enumerate(out.shape))
            out = _like(out, lambda t: _pad_tensor(t, plan), gshape, out.split)
    return out


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal (heat_tpu/core/manipulations.py:158): on the gathered
    array, split by the JAX package's rule."""
    sanitation.sanitize_in(a)
    result = torch.diagonal(a.larray, offset=offset, dim1=dim1, dim2=dim2).contiguous()
    split = None if a.split in (dim1, dim2) else a.split
    if split is not None:
        split -= sum(1 for d in (dim1, dim2) if d < split)
        split = min(split, result.ndim - 1)
    return _gathered(a, result, split)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """Extract or construct a diagonal (heat_tpu/core/manipulations.py:149)."""
    sanitation.sanitize_in(a)
    if a.ndim == 1:
        return _gathered(a, torch.diag(a.larray, offset), a.split)
    return diagonal(a, offset=offset)


def _first(arrays: Sequence, fname: str) -> DNDarray:
    ref = next((a for a in arrays if isinstance(a, DNDarray)), None)
    if ref is None:
        raise TypeError(f"{fname} expected at least one DNDarray input")
    return ref


def _with_split(x: DNDarray, split) -> DNDarray:
    return x if x.split == split else x._resplit_(split, exact=True)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join along a new axis (heat_tpu/core/manipulations.py:541): position
    by position when every operand is an array of one shape and split, else
    on the gathered operands.  The first array's split moves past the new
    axis."""
    arrays = list(arrays)
    ref = _first(arrays, "stack")
    shapes = {tuple(a.shape) for a in arrays}
    if len(shapes) != 1:
        raise ValueError("all input arrays must have the same shape")
    axis = stride_tricks.sanitize_axis(tuple(ref.shape) + (1,), axis)
    split = ref.split + 1 if ref.split is not None and axis <= ref.split else ref.split
    dtype = functools.reduce(torch.promote_types, [_torch_dtype(a) for a in arrays])
    gshape = ref.shape[:axis] + (len(arrays),) + ref.shape[axis:]
    if ref.split is not None and all(isinstance(a, DNDarray) and a.split == ref.split for a in arrays):
        shards = [torch.stack([a.shards[r].to(dtype) for a in arrays], dim=axis) for r in range(ref.comm.size)]
        result = DNDarray(shards, gshape, types.canonical_heat_type(dtype), split, ref.device, ref.comm)
    else:
        tdev = ref.shards[0].device
        parts = [(a.larray if isinstance(a, DNDarray) else torch.as_tensor(a, device=tdev)).to(dtype) for a in arrays]
        result = _gathered(ref, torch.stack(parts, dim=axis), split)
    if out is not None:
        return out._adopt(result)
    return result


def vstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack as rows (heat_tpu/core/manipulations.py:743): 1-D operands
    become rows; a 1-D split-0 array's elements stay split, on axis 1."""
    arrays = list(arrays)
    ref = _first(arrays, "vstack")
    prepared = [
        (expand_dims(a, 0) if a.ndim == 1 else a) if isinstance(a, DNDarray)
        else torch.as_tensor(a).reshape(1, -1) if torch.as_tensor(a).ndim == 1 else torch.as_tensor(a)
        for a in arrays
    ]
    split = ref.split if ref.ndim > 1 else (1 if ref.split == 0 else None)
    return _with_split(concatenate(prepared, axis=0), split)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    return vstack(arrays)


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack as columns of the second axis (the first for 1-D;
    heat_tpu/core/manipulations.py:213)."""
    arrays = list(arrays)
    ref = _first(arrays, "hstack")
    return concatenate(arrays, axis=0 if ref.ndim == 1 else 1)


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """1-D operands as columns, 2-D ones as they are
    (heat_tpu/core/manipulations.py:113); the first array's split survives
    only if it is 0."""
    arrays = list(arrays)
    ref = _first(arrays, "column_stack")
    prepared = [
        (expand_dims(a, 1) if a.ndim == 1 else a) if isinstance(a, DNDarray)
        else torch.as_tensor(a).reshape(-1, 1) if torch.as_tensor(a).ndim == 1 else torch.as_tensor(a)
        for a in arrays
    ]
    return _with_split(concatenate(prepared, axis=1), ref.split if ref.split == 0 else None)


def dstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack along the third axis (heat_tpu/core/manipulations.py:221):
    operands are made 3-D first ((n,) → (1, n, 1), (m, n) → (m, n, 1))."""
    arrays = list(arrays)
    ref = _first(arrays, "dstack")

    def three(a):
        if isinstance(a, DNDarray):
            return expand_dims(expand_dims(a, 0), 2) if a.ndim == 1 else expand_dims(a, 2) if a.ndim == 2 else a
        t = torch.as_tensor(a)
        return t.reshape(1, -1, 1) if t.ndim == 1 else t[..., None] if t.ndim == 2 else t

    if ref.ndim == 1:
        split = 1 if ref.split == 0 else None
    else:
        split = ref.split if (ref.split is not None and ref.split < 2) else None
    return _with_split(concatenate([three(a) for a in arrays], axis=2), split)


def split(x: DNDarray, indices_or_sections, axis: int = 0):
    """Cut into sub-arrays along ``axis`` (heat_tpu/core/manipulations.py:509):
    along another axis than the split axis each part is cut per shard and
    keeps the split; along the split axis the parts are cut from the
    gathered array and are replicated, as in the JAX package."""
    sanitation.sanitize_in(x)
    axis = stride_tricks.sanitize_axis(x.shape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy()
    n = x.shape[axis]
    if isinstance(indices_or_sections, (list, tuple, np.ndarray)):
        cuts = [int(i) for i in np.asarray(indices_or_sections).reshape(-1)]
        bounds = list(zip([None] + cuts, cuts + [None]))
    else:
        sections = int(indices_or_sections)
        if sections <= 0 or n % sections:
            raise ValueError("array split does not result in an equal division")
        step = n // sections
        bounds = [(i * step, (i + 1) * step) for i in range(sections)]
    parts = []
    for lo, hi in bounds:
        key = tuple(slice(lo, hi) if d == axis else slice(None) for d in range(x.ndim))
        if axis == x.split:
            parts.append(_gathered(x, x.larray[key].clone(), None))
        else:
            parts.append(x[key])
    return parts


def hsplit(x: DNDarray, indices_or_sections):
    """Split along axis 1 (axis 0 for 1-D)."""
    return split(x, indices_or_sections, axis=1 if x.ndim > 1 else 0)


def vsplit(x: DNDarray, indices_or_sections):
    return split(x, indices_or_sections, axis=0)


def dsplit(x: DNDarray, indices_or_sections):
    return split(x, indices_or_sections, axis=2)


DNDarray.reshape = lambda self, *shape, **kw: reshape(self, *shape, **kw)
DNDarray.flatten = lambda self: flatten(self)
DNDarray.ravel = lambda self: ravel(self)
DNDarray.squeeze = lambda self, axis=None: squeeze(self, axis)
DNDarray.expand_dims = lambda self, axis: expand_dims(self, axis)
DNDarray.flip = lambda self, axis=None: flip(self, axis)
DNDarray.rot90 = lambda self, k=1, axes=(0, 1): rot90(self, k, axes)
DNDarray.swapaxes = lambda self, axis1, axis2: swapaxes(self, axis1, axis2)
DNDarray.redistribute = lambda self, lshape_map=None, target_map=None: redistribute(self, lshape_map, target_map)
DNDarray.balance = lambda self, copy=False: balance(self, copy)


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Sort along ``axis``; returns (sorted, original indices)
    (heat_tpu/core/manipulations.py:425).  Along the split axis over several
    positions the block odd-even merge-split network of
    :mod:`parallel.sort` runs over the shards (int32 indices, as in the JAX
    package); along another axis each position sorts its own block, and a
    replicated array sorts once (int64 indices).  Both are stable, with NaN
    last ascending and first descending, and complex values in NumPy's
    lexicographic order."""
    sanitation.sanitize_in(a)
    if a.ndim == 0:
        raise ValueError(f"axis {axis} is out of bounds for array of dimension 0")
    axis = stride_tricks.sanitize_axis(a.shape, axis)
    if a.split == axis and a.is_distributed():
        values, indices, _ = distributed_sort(a.shards, axis, descending)
        v = DNDarray(values, a.shape, a.dtype, a.split, a.device, a.comm)
        i = DNDarray(indices, a.shape, types.int32, a.split, a.device, a.comm)
    elif a.split == axis:
        values, indices = stable_sort(a.larray, axis, descending)
        v = _gathered(a, values, a.split)
        i = _gathered(a, indices, a.split)
    else:
        v = _like(a, lambda t: stable_sort(t, axis, descending)[0], a.shape, a.split)
        i = _like(a, lambda t: stable_sort(t, axis, descending)[1], a.shape, a.split)
    if out is not None:
        return out._adopt(v), i
    return v, i


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The ``k`` largest (or smallest) values along ``dim`` and their
    indices (heat_tpu/core/manipulations.py:580), in ``lax.top_k``'s order:
    descending in IEEE totalOrder, ties by lower index.  Along the split
    axis over several positions each position ranks its own block and only
    the candidates are joined; the result is then replicated."""
    sanitation.sanitize_in(a)
    dim = stride_tricks.sanitize_axis(a.shape, dim)
    if k > a.shape[dim]:
        raise ValueError(f"k={k} exceeds dimension size {a.shape[dim]}")
    shape = tuple(int(k) if d == dim else s for d, s in enumerate(a.shape))
    if a.split == dim and a.is_distributed():
        values, indices = distributed_topk(a.shards, dim, int(k), largest)
        v = DNDarray([values] * a.comm.size, shape, a.dtype, None, a.device, a.comm)
        i = DNDarray([indices] * a.comm.size, shape, types.int64, None, a.device, a.comm)
    else:
        def pick(t):
            t = t.movedim(dim, -1)
            sel = topk_order(t, int(k), largest)
            return t.gather(-1, sel).movedim(-1, dim), sel.movedim(-1, dim)

        split = None if a.split == dim else a.split
        if a.split == dim:
            vals, sel = pick(a.larray)
            v, i = _gathered(a, vals, None), _gathered(a, sel, None)
        else:
            v = _like(a, lambda t: pick(t)[0], shape, split)
            i = _like(a, lambda t: pick(t)[1], shape, split)
    if out is not None:
        out[0]._adopt(v)
        out[1]._adopt(i)
        return out
    return v, i


def _plain(t) -> torch.Tensor:
    if isinstance(t, DNDarray):
        return t.larray
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))


def mpi_topk(a, b, dim: int = -1, largest: bool = True, sorted: bool = True):
    """Combine two partial top-k results (heat_tpu/core/manipulations.py:634):
    ``a`` and ``b`` are ``(values, indices)`` pairs, the result is the top
    ``k = a``'s extent along ``dim`` of their concatenation along ``dim``,
    as ``(values, indices)`` tensors, in ``lax.top_k``'s order (ties keep
    the element that comes first in the concatenation, ``a`` before ``b``)."""
    (av, ai), (bv, bi) = a, b
    av, ai, bv, bi = _plain(av), _plain(ai), _plain(bv), _plain(bi)
    k = av.shape[dim]
    values = torch.cat((av, bv.to(av.device)), dim=dim).movedim(dim, -1)
    indices = torch.cat((ai, bi.to(ai.device)), dim=dim).movedim(dim, -1)
    sel = topk_order(values, k, largest)
    return values.gather(-1, sel).movedim(-1, dim), indices.gather(-1, sel).movedim(-1, dim)


def _unique_sorted(flat: torch.Tensor):
    """Sorted uniques of a 1-D tensor with NaNs collapsed, and each
    element's position among them."""
    s, order = stable_sort(flat, 0)
    keep = torch.ones_like(s, dtype=torch.bool)
    if s.numel() > 1:
        same = s[1:] == s[:-1]
        if s.dtype.is_floating_point:
            same = same | (torch.isnan(s[1:]) & torch.isnan(s[:-1]))
        keep[1:] = ~same
    slot = torch.cumsum(keep, 0) - 1
    inverse = torch.empty_like(slot)
    inverse[order] = slot
    return s[keep], inverse


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis=None):
    """The sorted unique elements, replicated (their number depends on the
    data; heat_tpu/core/manipulations.py:658); NaNs collapse into one.  A
    1-D split-0 array over several positions is sorted by the distributed
    network and each position drops its repeats (:func:`parallel.sort.unique_compact_sorted`);
    its inverse (int32) keeps the input's split and is found per shard."""
    sanitation.sanitize_in(a)
    if axis is None and a.ndim == 1 and a.split == 0 and a.is_distributed():
        values, _, _ = distributed_sort(a.shards, 0)
        vals = torch.cat(unique_compact_sorted(values))
        v = DNDarray([vals] * a.comm.size, tuple(vals.shape), a.dtype, None, a.device, a.comm)
        if not return_inverse:
            return v
        nan_slot = None
        if vals.dtype.is_floating_point and vals.numel() and bool(torch.isnan(vals[-1])):
            nan_slot = vals.numel() - 1

        def inv(s):
            pos = searchsorted_left(vals, s).to(torch.int32)
            if nan_slot is not None:
                pos = torch.where(torch.isnan(s), torch.full_like(pos, nan_slot), pos)
            return pos

        return v, _like(a, inv, a.shape, a.split)
    if axis is None:
        vals, inverse = _unique_sorted(a.larray.reshape(-1))
        inverse = inverse.reshape(a.shape)
    else:
        axis = stride_tricks.sanitize_axis(a.shape, axis)
        vals, inverse = torch.unique(a.larray, sorted=True, return_inverse=True, dim=axis)
    v = DNDarray([vals] * a.comm.size, tuple(vals.shape), types.canonical_heat_type(vals.dtype), None, a.device, a.comm)
    if return_inverse:
        inv = DNDarray([inverse] * a.comm.size, tuple(inverse.shape), types.int64, None, a.device, a.comm)
        return v, inv
    return v
