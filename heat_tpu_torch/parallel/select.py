"""Distributed selection along the split axis over the shard list
(counterpart of heat_tpu/parallel/select.py): boolean-mask selection and
the pairing step of ``x[rows, cols]``.  The integer-array take is
:func:`transport.tiled_take`.

Mask selection is *compact and rebalance*, as in the JAX package: each
position keeps its selected rows (front-compacted, in order), an exclusive
prefix of the per-position counts (:func:`collectives.exscan`) places them
in the global output, and each destination chunk of the output is cut from
the compacted blocks that cover it.  The input is never gathered.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import collectives
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
    picked = []
    for s, m in zip(shards, mask_shards):
        m = m.to(device=s.device, dtype=torch.bool)
        if flatten:
            picked.append(s.reshape(-1)[m.reshape(-1)])
        else:
            picked.append(s.movedim(split, 0)[m])
    axis = 0 if flatten else split
    counts = [torch.tensor(p.shape[0], dtype=torch.int64) for p in picked]
    starts = [int(c) for c in collectives.exscan(counts)]
    out = []
    for lo, hi in _bounds(int(n_sel), comm.size):
        parts = []
        for p, st in zip(picked, starts):
            a, b = max(lo, st), min(hi, st + p.shape[0])
            if a < b:
                parts.append(p[a - st : b - st])
        block = torch.cat(parts) if parts else picked[0][:0]
        out.append(block if flatten else block.movedim(0, axis))
    return out


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
    out = []
    start = 0
    for y in shards:
        per = y.shape[t_ax]
        lc = cols[start : start + per].to(device=y.device, dtype=torch.int64)
        start += per
        ym = y.movedim(t_ax, 0)
        idx = lc.reshape([per] + [1] * (ym.ndim - 1)).expand(*([per] + [1 if d == p2_m else ym.shape[d] for d in range(1, ym.ndim)]))
        got = torch.take_along_dim(ym, idx, dim=p2_m).squeeze(p2_m)
        out.append(got.movedim(0, t_after))
    return out
