"""Distributed selection along the split axis over the shard list
(counterpart of heat_tpu/parallel/select.py): boolean-mask selection and
the pairing step of ``x[rows, cols]``.  The integer-array take is
:func:`transport.tiled_take`.

Mask selection is *compact and rebalance*, as in the JAX package: each
position keeps its selected rows (front-compacted, in order), an exclusive
prefix of the per-position counts (:func:`collectives.exscan`) places them
in the global output, and each destination chunk of the output is cut from
the compacted blocks that cover it.  The input is never gathered.  Across
processes the counts' prefix takes the collectives' process route, and the
picked rows whose destination lies in another process cross in one
:func:`collectives.exchange`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import collectives
from .mesh import RemoteShard
from .transport import _bounds

__all__ = ["distributed_mask_select", "distributed_pair_take"]


def distributed_mask_select(
    shards: Sequence[torch.Tensor],
    mask_shards: Sequence[torch.Tensor],
    split: int,
    n_sel: int,
    comm,
    flatten: bool = False,
) -> List[torch.Tensor]:
    """Select each shard's elements where its mask shard holds, along
    ``split`` (heat_tpu/parallel/select.py:107); returns the output's shards
    in the chunk rule's layout of extent ``n_sel`` along ``split``.
    ``flatten=True`` serves the full-``ndim`` mask of a split-0 array: each
    shard and its mask are flattened row-major first, and the output is 1-D.
    ``n_sel`` is the mask's true count."""
    local = comm.local_positions
    picked = {}
    for r in local:
        s, m = shards[r], mask_shards[r].to(device=shards[r].device, dtype=torch.bool)
        picked[r] = s.reshape(-1)[m.reshape(-1)] if flatten else s.movedim(split, 0)[m]
    axis = 0 if flatten else split
    like = picked[local[0]]
    dev = like.device
    if comm.spans_processes:
        # every position's count: one gather of this process's counts
        counts = collectives.all_gather([torch.tensor([picked[r].shape[0]], dtype=torch.int64, device=dev)
                                         for r in local], comm=comm, lengths=[1] * comm.size)[0]
        counts = counts.tolist()  # ht: HT002 ok — the counts size the blocks that cross
    else:
        counts = [int(picked[r].shape[0]) for r in local]
    starts = [sum(counts[:r]) for r in range(comm.size)]
    bounds = _bounds(int(n_sel), comm.size)

    def span(r, d):
        lo, hi = bounds[d]
        return max(lo, starts[r]), min(hi, starts[r] + counts[r])

    got = {}
    if comm.spans_processes:
        sends, specs = {}, {}
        for r in range(comm.size):
            for d in range(comm.size):
                a, b = span(r, d)
                if a >= b or comm.process_index(r) == comm.process_index(d):
                    continue
                if r in local:
                    sends[(r, d)] = picked[r][a - starts[r]: b - starts[r]]
                elif d in local:
                    specs[(r, d)] = ((b - a,) + tuple(like.shape[1:]), like.dtype)
        got = collectives.exchange(sends, specs, comm, dev)
    out = {}
    for d in local:
        parts = []
        for r in range(comm.size):
            a, b = span(r, d)
            if a < b:
                parts.append(got[(r, d)] if (r, d) in got else picked[r][a - starts[r]: b - starts[r]])
        block = torch.cat(parts) if parts else like[:0]
        out[d] = block if flatten else block.movedim(0, axis)

    def shape(d):
        rest = list(like.shape[1:])
        n = bounds[d][1] - bounds[d][0]
        return (n,) if flatten else tuple(rest[:axis] + [n] + rest[axis:])

    return [out[d] if d in out else RemoteShard(d, shape(d), like.dtype, dev) for d in range(comm.size)]


def distributed_pair_take(
    shards: Sequence[torch.Tensor], cols: torch.Tensor, t_ax: int, p2: int, comm
) -> List[torch.Tensor]:
    """The local pairing step of mixed advanced keys
    (heat_tpu/parallel/select.py:219): in the already-taken array (split
    along ``t_ax``), output element t takes ``y[..., t, ..., cols[t], ...]``
    and dimension ``p2`` is consumed.  ``cols`` is 1-D, as long as the
    ``t_ax`` extent, normalised to ``[0, dim_p2)``; each position reads its
    own span of it, with no exchange."""
    p2_m = p2 + 1 if p2 < t_ax else p2  # p2 after t moves to the front
    t_after = t_ax - (1 if p2 < t_ax else 0)  # t's position after the squeeze

    def take(r):
        y = shards[r]
        start = comm.chunk((int(cols.shape[0]),), 0, rank=r)[0]
        per = y.shape[t_ax]
        lc = cols[start : start + per].to(device=y.device, dtype=torch.int64)
        ym = y.movedim(t_ax, 0)
        idx = lc.reshape([per] + [1] * (ym.ndim - 1)).expand(*([per] + [1 if d == p2_m else ym.shape[d] for d in range(1, ym.ndim)]))
        got = torch.take_along_dim(ym, idx, dim=p2_m).squeeze(p2_m)
        return got.movedim(0, t_after)

    like = shards[comm.local_positions[0]]
    gshape = [e for d, e in enumerate(like.shape) if d != p2]
    gshape[t_after] = int(cols.shape[0])
    return comm.per_position(take, gshape, t_after)
