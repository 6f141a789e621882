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

With the fusion engine on (:mod:`~heat_tpu_torch.core.fusion`, the
default) and no ``out=``, each of the four builds a node of the lazy DAG
instead of running, as heat_tpu's do: one leaf per operand (scalars as 0-d
leaves), the ``where=`` select and its zero base as nodes of their own, a
float cast of integer input to a unary op as a cast node.  A node applies
the eager function of this module when its program runs, so fused values
are the eager values bit for bit.  :func:`_composite` defers any other
eager function of DNDarrays with static arguments as one node (the
statistics and the Euclidean ``cdist``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

import functools

from . import fusion, sanitation, types
from .dndarray import DNDarray, _tdevice, _wrap
from .stride_tricks import broadcast_shape, sanitize_axes_for_reduction, sanitize_axis
from ..parallel import collectives

__all__ = ["_binary_op", "_composite", "_cum_op", "_local_op", "_reduce_op"]


def _as_operand(x, ref: DNDarray):
    """DNDarrays pass through; python scalars become 0-d tensors of the
    scalar-aware ``result_type`` (a scalar never widens the array's dtype);
    other array-likes become replicated tensors on the array's device."""
    tdev = _tdevice(ref)
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


@functools.lru_cache(maxsize=None)
def _promoted(fn: Callable, inexact: bool = False) -> Callable:
    """``fn`` of two tensors cast to their common type (its inexact form
    with ``inexact``), as ``jnp``'s binary operations promote."""

    def op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = torch.promote_types(a.dtype, b.dtype)
        if inexact:
            t = _inexact_type(t)
        return fn(a.to(t), b.to(t))

    # one object per (fn, inexact): the fusion engine keys programs on it
    op.__name__ = getattr(fn, "__name__", "op")
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
    dt = types.canonical_heat_type(result.dtype).torch_type()
    base = out.larray.to(dt) if out is not None else torch.zeros((), dtype=dt)
    return _select(where, result, base)


def _select(where, result: DNDarray, base: torch.Tensor) -> DNDarray:
    """``torch.where(where, result, base)`` with ``result``'s split."""
    if isinstance(where, DNDarray):
        w = where.larray
    else:
        w = where if isinstance(where, torch.Tensor) else torch.as_tensor(np.asarray(where))
    r = result.larray
    masked = torch.where(w.to(r.device), r, base.to(r.device))
    return _wrap(masked, result.split, result.device, result.comm)


def _zeros(shape, dtype, device):
    """The zero base of a lazy ``where=`` select: a 0-d tensor, which the
    select broadcasts, as the eager path does."""
    return torch.zeros((), dtype=dtype, device=device)


fusion.register_op(_zeros, "zeros", kind="composite")
fusion.register_op(_select, "where", kind="composite")


def _lazy_operand(x, comm, fresh: bool = False):
    """DAG node for one operand: a lazy array gives its pending expression,
    a concrete one a pinned leaf over its shards, a tensor a replicated
    leaf.  A tensor the caller may still hold (not ``fresh``) is cloned, so
    a later write into it does not reach the chain.  Operands on meshes of
    different sizes cannot share one program."""
    if isinstance(x, DNDarray):
        if x.comm is not comm and x.comm.size != comm.size:
            raise fusion.Unfusable("operands live on different meshes")
        return fusion.leaf_from(x)
    return fusion.leaf(x if fresh else x.clone())


def _apply_binary(a, b, op):
    """The eager binary op of two node values (a program's step)."""
    return _binary_eager(op, a, b, None, None)


def _apply_local(x, op, no_cast):
    return _local_eager(op, x, None, no_cast)


def _apply_reduce(x, op, axis, keepdims, combine):
    return _reduce_eager(op, x, axis, keepdims, combine, None)


def _apply_cum(x, op, axis, combine, dtype):
    return _cum_eager(op, x, axis, combine, dtype, None)


fusion.register_op(_apply_binary, "binary", kind="elementwise")
fusion.register_op(_apply_local, "local", kind="elementwise")
fusion.register_op(_apply_reduce, "reduce", kind="reduction")
fusion.register_op(_apply_cum, "scan", kind="scan")


def _hashable_axis(axis):
    return tuple(axis) if isinstance(axis, list) else axis


def _defer(res, ref: DNDarray, tdev) -> DNDarray:
    a = res.aval
    return fusion.defer(res, a.shape, types.canonical_heat_type(a.dtype), a.split, ref.device, ref.comm, tdev)


def _composite(fn: Callable, x: DNDarray, *others, **static) -> DNDarray:
    """``fn(x, *others, **static)``, an eager function of DNDarrays with
    hashable static arguments, as one node of the lazy DAG while the
    fusion engine is on (else, or when it declines, run now)."""
    if fusion.enabled():
        try:
            comm = x.comm
            args = tuple(_lazy_operand(a, comm) for a in (x,) + others)
            res = fusion.node(fn, args, (x.device, comm), **static)
            if not res.aval.array:
                raise fusion.Unfusable(f"{fusion.op_name(fn)} returns a tensor")
            return _defer(res, x, _tdevice(x))
        except fusion.Unfusable:
            fusion.count_fallback()
    return fn(x, *others, **static)


def _binary_op(operation: Callable, t1, t2, out: Optional[DNDarray] = None, where=None) -> DNDarray:
    """Generic distributed binary operation with broadcasting; lazy while
    the fusion engine is on and ``out`` is None."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")
    if fusion.enabled() and out is None:
        try:
            return _lazy_binary(operation, t1, t2, where)
        except fusion.Unfusable:
            fusion.count_fallback()
    return _binary_eager(operation, t1, t2, out, where)


def _lazy_binary(operation, t1, t2, where) -> DNDarray:
    ref = t1 if isinstance(t1, DNDarray) else t2
    comm, tdev = ref.comm, _tdevice(ref)
    ctx = (ref.device, comm)
    n1 = _lazy_operand(_as_operand(t1, ref), comm, fresh=np.isscalar(t1))
    n2 = _lazy_operand(_as_operand(t2, ref), comm, fresh=np.isscalar(t2))
    res = fusion.node(_apply_binary, (n1, n2), ctx, op=operation)
    if where is not None:
        w = where if isinstance(where, DNDarray) else torch.as_tensor(np.asarray(where), device=tdev)
        base = fusion.node(_zeros, (), ctx, shape=res.aval.shape, dtype=res.aval.dtype, device=str(tdev))
        res = fusion.node(_select, (_lazy_operand(w, comm), res, base), ctx)
    return _defer(res, ref, tdev)


def _binary_eager(operation: Callable, t1, t2, out: Optional[DNDarray], where) -> DNDarray:
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
        shards = comm.per_position(
            lambda r: operation(_block(o1, out_shape, split, comm, r), _block(o2, out_shape, split, comm, r)),
            out_shape, split,
        )
        result = shards[0]
    wrapped = DNDarray(shards, out_shape, types.canonical_heat_type(result.dtype), split, device, comm)
    if where is not None:
        wrapped = _masked(wrapped, where, out)
    return _finish(wrapped, out)


def _local_op(operation: Callable, x: DNDarray, out: Optional[DNDarray] = None, no_cast: bool = False) -> DNDarray:
    """Elementwise operation; integer and bool input is cast to float32
    first unless ``no_cast`` (under fusion, a cast node)."""
    sanitation.sanitize_in(x)
    if fusion.enabled() and out is None:
        try:
            ctx = (x.device, x.comm)
            nx = _lazy_operand(x, x.comm)
            if not no_cast and not (nx.aval.dtype.is_floating_point or nx.aval.dtype.is_complex):
                nx = fusion.cast_node(nx, types.float32, ctx)
            res = fusion.node(_apply_local, (nx,), ctx, op=operation, no_cast=no_cast)
            return _defer(res, x, _tdevice(x))
        except fusion.Unfusable:
            fusion.count_fallback()
    return _local_eager(operation, x, out, no_cast)


def _local_eager(operation: Callable, x: DNDarray, out: Optional[DNDarray], no_cast: bool) -> DNDarray:
    def apply(t):
        if not no_cast and not (t.is_floating_point() or t.is_complex()):
            t = t.to(torch.float32)
        return operation(t)

    if x.split is None:
        shards = [apply(x.shards[0])] * x.comm.size
    else:
        src = x.shards
        shards = x.comm.per_position(lambda r: apply(src[r]), x.shape, x.split)
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
    return _fold(parts, combine)


def _fold(parts, combine: str) -> torch.Tensor:
    """``parts`` combined in order by ``"prod"``, ``"all"`` or ``"any"``."""
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
    the split axis merge across positions.  Under fusion a trailing
    reduction extends its producer's DAG."""
    sanitation.sanitize_in(x)
    if fusion.enabled() and out is None:
        try:
            nx = _lazy_operand(x, x.comm)
            res = fusion.node(_apply_reduce, (nx,), (x.device, x.comm), op=fn, axis=_hashable_axis(axis),
                              keepdims=bool(keepdims), combine=combine)
            return _defer(res, x, _tdevice(x))
        except fusion.Unfusable:
            fusion.count_fallback()
    return _reduce_eager(fn, x, axis, keepdims, combine, out)


def _reduce_eager(fn: Callable, x: DNDarray, axis, keepdims: bool, combine: str, out: Optional[DNDarray]) -> DNDarray:
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    comm = x.comm
    if x.split is None or x.split not in axes:
        if x.split is None:
            shards = [_apply_reduction(fn, x.shards[0], axes, keepdims)] * comm.size
        else:
            src = x.shards
            shards = comm.per_position(lambda r: _apply_reduction(fn, src[r], axes, keepdims),
                                       _gshape(x.shape, axes, keepdims),
                                       _reduce_split(x.split, axes, keepdims, len(x.shape) - (0 if keepdims else len(axes))))
    elif comm.is_process_comm and not (combine in ("argmin", "argmax") and len(axes) > 1):
        shards = [_reduce_across(fn, x, axes, keepdims, combine)] * comm.size
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


def _template(fn: Callable, x: DNDarray, axes, keepdims: bool, device) -> torch.Tensor:
    """Zeros on ``device`` of the shape and dtype of one position's partial
    result: the stand-in of a process whose shards are all empty, which
    contributes none but takes part in every collective."""
    shape = list(x.shape)
    shape[x.split] = 1
    meta = _apply_reduction(fn, torch.empty(shape, dtype=x.dtype.torch_type(), device="meta"), axes, keepdims)
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def _gather_rows(parts: dict, like: torch.Tensor, comm, device) -> torch.Tensor:
    """The partials of every position that has one, stacked in position
    order in every process: ``parts`` maps this process's positions to
    their partials."""
    rows = [
        parts[r].unsqueeze(0) if r in parts else torch.empty((0,) + tuple(like.shape), dtype=like.dtype, device=device)
        for r in comm.local_positions
    ]
    return collectives.all_gather(rows, dim=0, comm=comm)[0]


def _reduce_across(fn: Callable, x: DNDarray, axes, keepdims: bool, combine: str) -> torch.Tensor:
    """A reduction over the split axis of an array on a process comm: each
    of this process's non-empty shards reduces alone, then the partials
    merge across processes through the collectives' process route, in
    position order as on one process."""
    comm, src = x.comm, x.shards
    dev = src[comm.local_positions[0]].device
    live = [r for r in comm.local_positions if src[r].shape[x.split] > 0]
    if combine in ("argmin", "argmax"):
        return _arg_across(x, live, axes[0], keepdims, largest=combine == "argmax")
    like = _template(fn, x, axes, keepdims, dev)
    parts = [_apply_reduction(fn, src[r], axes, keepdims) for r in live]
    if combine in ("sum", "min", "max"):
        merge = {"sum": collectives.psum, "min": collectives.pmin, "max": collectives.pmax}[combine]
        return merge(parts, comm=comm, like=like)[0]
    rows = _gather_rows(dict(zip(live, parts)), like, comm, dev)
    if rows.shape[0] == 0:  # every shard empty: the reduction of an empty shard
        return _apply_reduction(fn, src[comm.local_positions[0]], axes, keepdims)
    return _fold(list(rows.unbind(0)), combine)


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
    candidates = []
    for r in live:
        s = x.shards[r]
        if s.dtype == torch.bool:
            s = s.to(torch.uint8)
        off = x.comm.chunk(x.shape, x.split, rank=r)[0]
        candidates.append((extreme(s, dim=axis, keepdim=keepdims), pick(s, dim=axis, keepdim=keepdims) + off))
    comm = x.comm
    if comm.is_process_comm:
        # every process's candidates, in position order
        dt = torch.uint8 if x.dtype.torch_type() == torch.bool else x.dtype.torch_type()
        like = extreme(torch.empty([1 if d == x.split else n for d, n in enumerate(x.shape)], dtype=dt, device="meta"),
                       dim=axis, keepdim=keepdims)
        dev = x.shards[comm.local_positions[0]].device
        vs = _gather_rows({r: v for r, (v, _) in zip(live, candidates)}, like, comm, dev)
        ids = _gather_rows({r: i for r, (_, i) in zip(live, candidates)}, like.to(torch.int64), comm, dev)
        candidates = list(zip(vs.unbind(0), ids.unbind(0)))
    best_v = best_i = None
    for v, i in candidates:
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
    if fusion.enabled() and out is None:
        try:
            nx = _lazy_operand(x, x.comm)
            res = fusion.node(_apply_cum, (nx,), (x.device, x.comm), op=fn, axis=axis, combine=combine,
                              dtype=None if dtype is None else types.canonical_heat_type(dtype))
            return _defer(res, x, _tdevice(x))
        except fusion.Unfusable:
            fusion.count_fallback()
    return _cum_eager(fn, x, axis, combine, dtype, out)


def _cum_eager(fn: Callable, x: DNDarray, axis: int, combine: str, dtype, out: Optional[DNDarray]) -> DNDarray:
    comm, src = x.comm, x.shards
    shards = {r: src[r] for r in ((0,) if x.split is None else comm.local_positions)}
    if dtype is not None:
        shards = {r: s.to(types.canonical_heat_type(dtype).torch_type()) for r, s in shards.items()}
    first = next(iter(shards.values()))
    keep = torch.int64 if first.dtype == torch.bool else first.dtype
    if x.split == axis and comm.is_process_comm:
        across = _cum_across if combine == "sum" else _cumprod_across
        return _finish(across(fn, x, shards, axis, keep), out)
    scanned = {r: fn(s, axis).to(keep) for r, s in shards.items()}
    if x.split == axis and len(scanned) > 1:
        run = None
        for r, sc in scanned.items():
            if sc.shape[axis] == 0:
                continue
            if run is not None:
                scanned[r] = (sc + run if combine == "sum" else sc * run).to(keep)
            run = scanned[r].narrow(axis, sc.shape[axis] - 1, 1)
    if x.split is None:
        result = [scanned[0]] * comm.size
    else:
        result = comm.per_position(lambda r: scanned[r], x.shape, x.split)
    return _finish(DNDarray(result, x.shape, types.canonical_heat_type(keep), x.split, x.device, comm), out)


def _cum_across(fn: Callable, x: DNDarray, shards, axis: int, keep: torch.dtype) -> DNDarray:
    """A cumulative sum along the split axis on a process comm: each of this
    process's shards scans alone, then adds the exclusive scan
    (:func:`collectives.exscan`, its process route) of the shards' totals."""
    comm = x.comm
    local = comm.local_positions
    scanned = {r: fn(shards[r], axis).to(keep) for r in local}
    row = [1 if d == axis else n for d, n in enumerate(x.shape)]
    totals = [
        sc.narrow(axis, sc.shape[axis] - 1, 1) if sc.shape[axis] else torch.zeros(row, dtype=keep, device=sc.device)
        for sc in scanned.values()
    ]
    for r, before in zip(local, collectives.exscan(totals, comm=comm)):
        scanned[r] = (scanned[r] + before).to(keep)
    out = comm.per_position(lambda r: scanned[r], x.shape, axis)
    return DNDarray(out, x.shape, types.canonical_heat_type(keep), x.split, x.device, comm)


def _cumprod_across(fn: Callable, x: DNDarray, shards, axis: int, keep: torch.dtype) -> DNDarray:
    """A cumulative product along the split axis on a process comm: each of
    this process's shards scans alone; the last rows of every position's
    scan are gathered (:func:`collectives.all_gather`, one row a non-empty
    position), and every process chains them in position order exactly as
    one process does (each position's product with the combined last row
    before it), so the values are the single controller's bit for bit."""
    comm = x.comm
    local = comm.local_positions
    scanned = {r: fn(shards[r], axis).to(keep) for r in local}
    sizes = [int(n) for n in comm.lshape_map(x.shape, axis)[:, axis]]
    lasts = [scanned[r].narrow(axis, max(sizes[r] - 1, 0), min(sizes[r], 1)) for r in local]
    rows = collectives.all_gather(lasts, dim=axis, comm=comm, lengths=[min(n, 1) for n in sizes])[0]
    run, before, at = None, {}, 0
    for r in range(comm.size):
        if not sizes[r]:
            continue
        before[r] = run
        last = rows.narrow(axis, at, 1)
        run = last if run is None else (last * run).to(keep)
        at += 1
    for r in local:
        if before.get(r) is not None:
            scanned[r] = (scanned[r] * before[r].to(scanned[r].device)).to(keep)
    out = comm.per_position(lambda r: scanned[r], x.shape, axis)
    return DNDarray(out, x.shape, types.canonical_heat_type(keep), x.split, x.device, comm)
