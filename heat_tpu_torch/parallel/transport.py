"""The transport engine over the shard list: resplit, split-crossing
reshape and row take (counterpart of heat_tpu/parallel/transport.py).

Every layout change of a split array is a data-movement program whose
destination shards are known on the host from the chunk rule alone.  The
JAX package runs each as a loop of bounded tiles of one collective; under
the port's single controller every position's shard is in hand, so each
destination shard is assembled directly from the pieces of the source
shards that cover it, and the result never passes through the gathered
array:

``tiled_resplit``
    split ``sa`` → split ``sb`` (the all-to-all of ``_build_tiled_resplit``):
    destination shard d is the concatenation along ``sa`` of every source
    shard's ``narrow`` view of d's chunk of ``sb``.  The caller drops the
    old shards afterwards (``DNDarray.resplit_``), the port's form of
    donation.
``tiled_reshape``
    a reshape whose split dimension and everything before it keep their
    extent reshapes each shard as a view; any other one runs resplit to
    split 0, a flat *rechunk*, and resplit to the target split.  The
    rechunk follows :func:`rechunk_plan`: each (source, destination) overlap
    is one contiguous interval, so destination d is covered exactly by at
    most 1 + ``_MAX_SHIFTS`` intervals, one per ring shift, and one launch
    of the repack kernel (K7, :mod:`heat_tpu_torch.ops.repack`) writes it in
    its final shape.  A destination with no rows launches nothing.
``tiled_take``
    ``out[t] = in[rows[t]]`` along the split axis, per destination chunk
    of the output: each source shard contributes the requested rows it
    owns (the ``psum_scatter`` of ``_build_tiled_gather``, in plain torch).
``rechunk_rows``, ``RowSource``
    the assignment side (``DNDarray.__setitem__``): a split value's rows
    re-cut at explicit destination bounds, where a key meets each
    position, by K7 (``rechunk_rows``, into a shard's row range or a
    piece-sized buffer); and the value rows a position receives, by range
    or by index, each from the value shard that holds it (``RowSource``,
    the reverse of ``tiled_take``).

Not ported (ROADMAP queue 1, item 13): the wire formats, the autotune arms,
telemetry and memory tracking, the OOM back-off, fused split tails, and
``tile_plan``/``TILE_BYTES``: under one controller on one card nothing is
staged, and tiling returns with several processes (item 14).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..ops import repack as _repack

__all__ = [
    "RowSource",
    "rechunk_plan",
    "rechunk_rows",
    "reshape_applicable",
    "resplit_applicable",
    "tiled_reshape",
    "tiled_resplit",
    "tiled_take",
]

# Beyond this many distinct ring shifts the rechunk degenerates toward a
# latency-bound permute chain; callers fall back to the gathered route
# (heat_tpu/parallel/transport.py:298).
_MAX_SHIFTS = 4

# bytes of rows a take gathers at a time into a destination shard
_TAKE_BYTES = 64 << 20


def _bounds(n: int, S: int) -> List[Tuple[int, int]]:
    """(start, stop) of each position's chunk of an extent ``n``: even
    ``ceil(n/S)`` chunks, the trailing ones truncated (MeshComm.chunk)."""
    per = -(-n // S) if n > 0 else 0
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(S)]


def _prefix_prod(shape: Sequence[int], k: int) -> int:
    return math.prod(int(e) for e in shape[:k])


def _ranges(bounds, m: int, rowsz: int) -> List[Tuple[int, int]]:
    """Explicit per-destination (start, stop) rows as element ranges, each
    inside [0, m)."""
    if any(not 0 <= int(lo) <= int(hi) <= m for lo, hi in bounds):
        raise ValueError(f"destination bounds {list(bounds)} do not lie in [0, {m})")
    return [(int(lo) * rowsz, int(hi) * rowsz) for lo, hi in bounds]


def rechunk_plan(m_in, rowsz_in, m_out, rowsz_out, S, dst_bounds=None, max_shifts=_MAX_SHIFTS):
    """Host plan for moving the flat element stream from split-0 rows of
    size ``rowsz_in`` to split-0 rows of size ``rowsz_out``
    (heat_tpu/parallel/transport.py:1036; equal results).

    Both chunk boundary sets are host-known, so each (source, destination)
    overlap is one contiguous interval; entries are grouped by ring shift
    ``(d - r) % S`` and, per shift, hold tuples indexed by SOURCE shard of
    (local source offset, destination-local offset, length).  Returns a
    hashable tuple of ``(shift, src_off, dst_off, lens)`` entries, or
    ``None`` when the plan needs more than ``max_shifts`` distinct nonzero
    shifts (no limit for ``None``), or the sizes disagree or are 0.
    ``dst_bounds``, one (start, stop) of output rows per destination, each
    inside [0, m_out), replaces the chunk rule on the destination side: the
    rows where an assignment's key meets each position (a destination may
    also take rows another one takes, or none)."""
    M = m_in * rowsz_in
    if M != m_out * rowsz_out or M == 0:
        return None
    pa = -(-m_in // S)
    B_in = [min(r * pa, m_in) * rowsz_in for r in range(S + 1)]
    if dst_bounds is None:
        pb = -(-m_out // S)
        R_out = [(min(d * pb, m_out) * rowsz_out, min((d + 1) * pb, m_out) * rowsz_out) for d in range(S)]
    else:
        R_out = _ranges(dst_bounds, m_out, rowsz_out)
    shifts = {}
    for r in range(S):
        lo_r, hi_r = B_in[r], B_in[r + 1]
        if lo_r == hi_r:
            continue
        for d, (lo_d, hi_d) in enumerate(R_out):
            lo = max(lo_r, lo_d)
            hi = min(hi_r, hi_d)
            if lo >= hi:
                continue
            s = (d - r) % S
            ent = shifts.setdefault(s, {"src": [0] * S, "dst": [0] * S, "len": [0] * S})
            ent["src"][r] = lo - B_in[r]
            ent["dst"][r] = lo - lo_d
            ent["len"][r] = hi - lo
    if max_shifts is not None and sum(1 for s in shifts if s != 0) > max_shifts:
        return None
    return tuple(
        (s, tuple(e["src"]), tuple(e["dst"]), tuple(e["len"])) for s, e in sorted(shifts.items())
    )


def resplit_applicable(gshape: Sequence[int], sa, sb, comm) -> bool:
    """True iff :func:`tiled_resplit` handles this layout change: a real
    axis-to-axis move over several positions with every extent nonzero
    (heat_tpu/parallel/transport.py:560)."""
    return (
        comm.size > 1
        and sa is not None
        and sb is not None
        and sa != sb
        and len(gshape) >= 2
        and all(int(d) > 0 for d in gshape)
    )


def reshape_applicable(gin, si, gout, so, comm) -> bool:
    """True iff :func:`tiled_reshape` handles this reshape: split input and
    output over several positions, every extent nonzero, and a rechunk plan
    within the shift budget (heat_tpu/parallel/transport.py:1204)."""
    if comm.size <= 1 or si is None or so is None:
        return False
    if any(int(d) <= 0 for d in gin) or any(int(d) <= 0 for d in gout):
        return False
    if _prefix_prod(gin, si) == _prefix_prod(gout, so) and int(gin[si]) == int(gout[so]):
        return True  # split-preserving: the per-shard path
    rowsz_in = _prefix_prod(gin, len(gin)) // int(gin[0])
    rowsz_out = _prefix_prod(gout, len(gout)) // int(gout[0])
    return rechunk_plan(int(gin[0]), rowsz_in, int(gout[0]), rowsz_out, comm.size) is not None


def tiled_resplit(shards: Sequence[torch.Tensor], gshape: Sequence[int], sa: int, sb: int, comm) -> List[torch.Tensor]:
    """The shards of a ``gshape`` array split along ``sa``, moved to split
    ``sb`` (heat_tpu/parallel/transport.py:574): destination shard d joins,
    along ``sa``, each source shard's view of d's chunk of ``sb``.  The
    result's shards are new contiguous tensors; the sources are untouched."""
    if len(shards) != comm.size:
        raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
    return [
        torch.cat([s.narrow(sb, lo, hi - lo) for s in shards], dim=sa)
        for lo, hi in _bounds(int(gshape[sb]), comm.size)
    ]


def _rechunk(flat: Sequence[torch.Tensor], plan, gout: Tuple[int, ...], comm, dst_bounds=None, out=None) -> List:
    """Split-0 shards of ``gout`` from the flat split-0 source shards
    ``flat`` following ``plan``: one K7 call per destination with rows, or
    one per :data:`~heat_tpu_torch.ops.repack.MAX_SEGMENTS` segments where
    more source chunks cover it.  ``dst_bounds`` as in :func:`rechunk_plan`;
    ``out``, one contiguous tensor (or ``None``) per destination, is
    written in place of a new one.  A destination without rows gets an
    empty tensor, or ``None`` when ``out`` is given."""
    S = comm.size
    res = []
    bounds = _bounds(gout[0], S) if dst_bounds is None else dst_bounds
    for d, (lo, hi) in enumerate(bounds):
        shape = (hi - lo,) + tuple(gout[1:])
        if hi == lo:
            res.append(flat[0].new_empty(shape) if out is None else None)
            continue
        segs = []
        for s, src_off, dst_off, lens in plan:
            r = (d - s) % S
            if lens[r]:
                segs.append((dst_off[r], r, src_off[r], lens[r]))
        segs.sort()
        at = 0
        for dst, _, _, length in segs:
            if dst != at:
                raise AssertionError(f"rechunk plan leaves a gap or overlap at element {at} of destination {d}")
            at += length
        if at != math.prod(shape):
            raise AssertionError(f"rechunk plan covers {at} of destination {d}'s {math.prod(shape)} elements")
        dest = out[d] if out is not None and out[d] is not None else None
        if len(segs) <= _repack.MAX_SEGMENTS:
            res.append(_repack.repack_segments([(flat[r], so, ln) for _, r, so, ln in segs], shape, out=dest))
            continue
        if dest is None:
            dest = flat[0].new_empty(shape)
        whole = dest.view(-1)
        for i in range(0, len(segs), _repack.MAX_SEGMENTS):
            group = segs[i : i + _repack.MAX_SEGMENTS]
            n = sum(length for *_, length in group)
            _repack.repack_segments([(flat[r], so, ln) for _, r, so, ln in group], (n,), out=whole.narrow(0, group[0][0], n))
        res.append(dest)
    return res


def rechunk_rows(shards: Sequence[torch.Tensor], dst_bounds, comm, out=None) -> List:
    """The rows of a split-0 array (``shards`` in the chunk rule, each
    contiguous) re-cut at explicit destination bounds: for each position,
    its (start, stop) of the array's rows.  Each destination with rows is
    written by K7 from the source chunks that cover it, into ``out[d]`` (a
    contiguous tensor of those rows' shape, such as a shard's row range)
    or into a new tensor; destinations without rows give ``None``.  Bit
    for bit; no other copy of the array exists."""
    m = sum(int(s.shape[0]) for s in shards)
    tail = tuple(shards[0].shape[1:])
    rowsz = math.prod(tail)
    if m == 0 or rowsz == 0:
        return [None] * comm.size
    plan = rechunk_plan(m, rowsz, m, rowsz, comm.size, dst_bounds=dst_bounds, max_shifts=None)
    flat = [s.view(-1) for s in shards]
    return _rechunk(flat, plan, (m,) + tail, comm, dst_bounds=dst_bounds, out=out if out is not None else [None] * comm.size)


def tiled_reshape(
    shards: Sequence[torch.Tensor], gin: Sequence[int], si: int, gout: Sequence[int], so: int, comm
) -> List[torch.Tensor]:
    """The shards of the reshape of a ``gin`` array split along ``si`` to
    ``gout`` split along ``so`` (heat_tpu/parallel/transport.py:1224).
    Callers check :func:`reshape_applicable` first."""
    S = comm.size
    gin = tuple(int(d) for d in gin)
    gout = tuple(int(d) for d in gout)
    if _prefix_prod(gin, si) == _prefix_prod(gout, so) and gin[si] == gout[so]:
        # split-preserving: chunk boundaries never crossed, each position
        # reshapes its own block
        out = []
        for s in shards:
            local = list(gout)
            local[so] = s.shape[si]
            out.append(s.reshape(local))
        return out
    if si != 0:
        shards = tiled_resplit(shards, gin, si, 0, comm)
    rowsz_in = _prefix_prod(gin, len(gin)) // gin[0]
    rowsz_out = _prefix_prod(gout, len(gout)) // gout[0]
    plan = rechunk_plan(gin[0], rowsz_in, gout[0], rowsz_out, S)
    if plan is None:
        raise ValueError(f"no rechunk plan within {_MAX_SHIFTS} shifts for {gin} -> {gout} over {S} positions")
    # the kernel reads contiguous flat sources: a strided split-0 shard
    # (a view a caller built) is copied here, explicitly
    flat = [s.contiguous().view(-1) for s in shards]
    del shards
    out = _rechunk(flat, plan, gout, comm)
    del flat
    if so != 0:
        out = tiled_resplit(out, gout, 0, so, comm)
    return out


def tiled_take(
    shards: Sequence[torch.Tensor], rows: torch.Tensor, n: int, split: int, comm
) -> List[torch.Tensor]:
    """``out[t] = in[rows[t]]`` along ``split`` of an array whose extent
    there is ``n``, as the output's shards (heat_tpu/parallel/transport.py:395).
    ``rows`` is a 1-D integer tensor already normalised to ``[0, n)``; the
    output's extent along ``split`` is ``len(rows)``, cut by the chunk rule.
    Each requested row has one owner, the position whose chunk holds it;
    a destination chunk gathers from each owner only the rows it owns and
    copies them into place, so every output row moves once, at most
    ``_TAKE_BYTES`` of them at a time beside the output.  The host reads
    one (destination, owner) table of row counts per call."""
    S = comm.size
    src_b = _bounds(int(n), S)
    dst_b = _bounds(int(rows.numel()), S)
    dev = shards[0].device
    rows = rows.to(device=dev, dtype=torch.int64)
    # the first position whose chunk ends past a row owns it (empty chunks
    # end where their predecessor does, so they own nothing)
    owner = torch.searchsorted(torch.tensor([hi for _, hi in src_b], dtype=torch.int64, device=dev), rows, right=True)
    per = max(dst_b[0][1], 1)
    dest = torch.arange(rows.numel(), device=dev) // per
    # rows a gather moves at a time: what is in flight beside the output
    # stays under _TAKE_BYTES
    row_bytes = shards[0].element_size() * max(1, math.prod(e for i, e in enumerate(shards[0].shape) if i != split))
    batch = max(1, _TAKE_BYTES // row_bytes)
    counts = torch.bincount(dest * S + owner, minlength=S * S).view(S, S).tolist()
    out = []
    for d, (lo, hi) in enumerate(dst_b):
        idx = rows[lo:hi]
        sole = [r for r in range(S) if hi > lo and counts[d][r] == hi - lo]
        if sole:
            r = sole[0]
            out.append(shards[r].index_select(split, idx - src_b[r][0]))
            continue
        shape = list(shards[0].shape)
        shape[split] = hi - lo
        block = shards[0].new_empty(shape)
        order = torch.argsort(owner[lo:hi], stable=True)
        at = 0
        for r, c in enumerate(counts[d]):
            for b in range(at, at + c, batch):
                pos = order[b : min(b + batch, at + c)]
                block.index_copy_(split, pos, shards[r].index_select(split, idx[pos] - src_b[r][0]))
            at += c
        out.append(block)
    return out


class RowSource:
    """A value to assign, laid along dimension ``dim`` of the region it
    fills, whose extent there is ``n``: a tensor already broadcast to the
    region (``tensor``), or the shards of a split array cut along ``dim``
    by the chunk rule (``shards``).  ``reverse`` reads the rows backwards
    (the region's rows ascend where the key's slice steps down).

    A destination position takes the rows it receives with :meth:`range`
    (a mask's or a slice's contiguous run) or :meth:`take` (the rows of an
    integer key it owns, the reverse of :func:`tiled_take`).  From shards,
    each value row is read from the shard that holds it, once; the value
    is never gathered."""

    def __init__(self, dim: int, n: int, tensor: torch.Tensor = None, shards: Sequence[torch.Tensor] = None,
                 reverse: bool = False):
        self.dim, self.n, self.tensor, self.reverse = dim, int(n), tensor, reverse
        self.shards = None if shards is None else list(shards)
        self.bounds = None if shards is None else _bounds(self.n, len(self.shards))

    def range(self, a: int, b: int) -> torch.Tensor:
        """Region rows [a, b) along :attr:`dim`."""
        if self.reverse:
            return self._range(self.n - b, self.n - a).flip(self.dim)
        return self._range(a, b)

    def _range(self, a: int, b: int) -> torch.Tensor:
        if self.tensor is not None:
            return self.tensor.narrow(self.dim, a, b - a)
        parts = [s.narrow(self.dim, max(a, lo) - lo, min(b, hi) - max(a, lo))
                 for s, (lo, hi) in zip(self.shards, self.bounds) if max(a, lo) < min(b, hi)]
        if not parts:
            return self.shards[0].narrow(self.dim, 0, 0)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.dim)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Region rows ``idx`` (a 1-D int64 tensor) along :attr:`dim`, in
        that order."""
        if self.reverse:
            idx = self.n - 1 - idx
        if self.tensor is not None:
            return self.tensor.index_select(self.dim, idx.to(self.tensor.device))
        dev = self.shards[0].device
        idx = idx.to(dev)
        owner = torch.searchsorted(torch.tensor([hi for _, hi in self.bounds], dtype=torch.int64, device=dev), idx, right=True)
        shape = list(self.shards[0].shape)
        shape[self.dim] = int(idx.numel())
        out = self.shards[0].new_empty(shape)
        for q, (s, (lo, _)) in enumerate(zip(self.shards, self.bounds)):
            pos = torch.nonzero(owner == q).reshape(-1)
            if pos.numel():
                out.index_copy_(self.dim, pos, s.index_select(self.dim, idx[pos] - lo))
        return out
