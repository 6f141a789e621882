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
    "rechunk_plan",
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


def _bounds(n: int, S: int) -> List[Tuple[int, int]]:
    """(start, stop) of each position's chunk of an extent ``n``: even
    ``ceil(n/S)`` chunks, the trailing ones truncated (MeshComm.chunk)."""
    per = -(-n // S) if n > 0 else 0
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(S)]


def _prefix_prod(shape: Sequence[int], k: int) -> int:
    return math.prod(int(e) for e in shape[:k])


def rechunk_plan(m_in, rowsz_in, m_out, rowsz_out, S):
    """Host plan for moving the flat element stream from split-0 rows of
    size ``rowsz_in`` to split-0 rows of size ``rowsz_out``
    (heat_tpu/parallel/transport.py:1036; equal results).

    Both chunk boundary sets are host-known, so each (source, destination)
    overlap is one contiguous interval; entries are grouped by ring shift
    ``(d - r) % S`` and, per shift, hold tuples indexed by SOURCE shard of
    (local source offset, destination-local offset, length).  Returns a
    hashable tuple of ``(shift, src_off, dst_off, lens)`` entries, or
    ``None`` when the plan needs more than ``_MAX_SHIFTS`` distinct nonzero
    shifts (or the sizes disagree or are 0)."""
    M = m_in * rowsz_in
    if M != m_out * rowsz_out or M == 0:
        return None
    pa = -(-m_in // S)
    pb = -(-m_out // S)
    B_in = [min(r * pa, m_in) * rowsz_in for r in range(S + 1)]
    B_out = [min(d * pb, m_out) * rowsz_out for d in range(S + 1)]
    shifts = {}
    for r in range(S):
        lo_r, hi_r = B_in[r], B_in[r + 1]
        if lo_r == hi_r:
            continue
        for d in range(S):
            lo = max(lo_r, B_out[d])
            hi = min(hi_r, B_out[d + 1])
            if lo >= hi:
                continue
            s = (d - r) % S
            ent = shifts.setdefault(s, {"src": [0] * S, "dst": [0] * S, "len": [0] * S})
            ent["src"][r] = lo - B_in[r]
            ent["dst"][r] = lo - B_out[d]
            ent["len"][r] = hi - lo
    if sum(1 for s in shifts if s != 0) > _MAX_SHIFTS:
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


def _rechunk(flat: Sequence[torch.Tensor], plan, gout: Tuple[int, ...], comm) -> List[torch.Tensor]:
    """Split-0 shards of ``gout`` from the flat split-0 source shards
    ``flat`` following ``plan``: one K7 call per destination with rows."""
    S = comm.size
    out = []
    for d, (lo, hi) in enumerate(_bounds(gout[0], S)):
        shape = (hi - lo,) + tuple(gout[1:])
        if hi == lo:
            out.append(flat[0].new_empty(shape))
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
        out.append(_repack.repack_segments([(flat[r], so, ln) for _, r, so, ln in segs], shape))
    return out


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
    copies them into place, so every output row moves once.  The host
    reads one (destination, owner) table of row counts per call."""
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
            if c:
                pos = order[at : at + c]
                block.index_copy_(split, pos, shards[r].index_select(split, idx[pos] - src_b[r][0]))
                at += c
        out.append(block)
    return out
