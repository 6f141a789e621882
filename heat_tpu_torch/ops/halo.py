"""Halo exchange over the shard list (counterpart of heat_tpu/ops/halo.py).

A halo is the rows a position needs from its neighbours along the split
axis to compute near its shard's edges: the last ``halo_size`` rows of the
previous position and the first ``halo_size`` rows of the next.  The JAX
package exchanges them with a pair of ``collective_permute`` inside its
compiled program; under the port's single controller each position's
neighbours are in hand, so the exchange is a pair of slices of the
neighbouring shards (:func:`parallel.collectives.ppermute` semantics) and
no kernel is involved.

:func:`halo_exchange` works on the shards as the JAX package's works on its
physical blocks, each padded with zeros to the chunk size; global edges get
zeros unless ``wrap``.  :func:`map_with_halos` runs a stencil over each
shard with its halos; :func:`exchange_halos` backs ``DNDarray.get_halo``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["exchange_halos", "halo_exchange", "map_with_halos"]


def _physical(t: torch.Tensor, axis: int, rows: int) -> torch.Tensor:
    """``t`` padded with zero rows along ``axis`` to ``rows``."""
    short = rows - t.shape[axis]
    if short <= 0:
        return t
    pad = list(t.shape)
    pad[axis] = short
    return torch.cat([t, t.new_zeros(pad)], dim=axis)


def halo_exchange(local: Sequence[torch.Tensor], halo_size: int, axis_name: Optional[str] = None, *, axis: int = 0,
                  wrap: bool = False) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(prev_halos, next_halos)`` of each position's block in ``local``
    (heat_tpu/ops/halo.py:30): position r's prev halo is the last
    ``halo_size`` rows along ``axis`` of block r − 1, its next halo the first
    ``halo_size`` rows of block r + 1.  The first position's prev and the
    last one's next are zeros unless ``wrap`` (then the ring closes).
    ``axis_name`` is accepted for parity: the positions are the list."""
    n = len(local)
    if any(halo_size > b.shape[axis] for b in local):
        raise ValueError(f"halo_size {halo_size} exceeds a block of {min(b.shape[axis] for b in local)} rows")
    first = [b.narrow(axis, 0, halo_size) for b in local]
    last = [b.narrow(axis, b.shape[axis] - halo_size, halo_size) for b in local]
    prev = [last[(r - 1) % n] for r in range(n)]
    nxt = [first[(r + 1) % n] for r in range(n)]
    if not wrap:
        prev[0] = torch.zeros_like(prev[0])
        nxt[n - 1] = torch.zeros_like(nxt[n - 1])
    return prev, nxt


def map_with_halos(fn: Callable, x, halo_size: int, *, wrap: bool = False):
    """Run ``fn(block_with_halos, edge)`` on every shard of a split DNDarray
    and assemble the results, split as ``x`` (heat_tpu/ops/halo.py:68).

    As in the JAX package, each block is the shard padded with zeros to the
    chunk size (the physical layout), with ``halo_size`` rows of each
    neighbour's block attached along the split axis; ``edge`` is the bool
    pair (has a previous, has a next position), both True with ``wrap``.
    ``fn`` returns a block of the chunk size along the split axis, of which
    the shard's rows are kept.  A replicated ``x`` is padded with
    ``halo_size`` zero rows at each end and passed whole with both edges
    False."""
    from ..core import types
    from ..core.dndarray import DNDarray, _wrap

    if not isinstance(x, DNDarray):
        raise TypeError(f"map_with_halos expects a DNDarray, got {type(x)}")
    if x.split is None:
        t = x.shards[0]
        pad = [0, 0] * t.ndim
        pad[2 * (t.ndim - 1)] = pad[2 * (t.ndim - 1) + 1] = halo_size
        edge = torch.tensor([False, False], device=t.device)
        out = fn(torch.nn.functional.pad(t, pad), edge)
        return _wrap(out, None, x.device, x.comm)
    split, n = x.split, x.comm.size
    chunk = max(x.comm.chunk(x.shape, split, rank=0)[1][split], 1)
    blocks = [_physical(s, split, chunk) for s in x.shards]
    prev, nxt = halo_exchange(blocks, halo_size, axis=split, wrap=wrap)
    shards = []
    for r, s in enumerate(x.shards):
        edge = torch.tensor([wrap or r > 0, wrap or r < n - 1], device=s.device)
        out = fn(torch.cat([prev[r], blocks[r], nxt[r]], dim=split), edge)
        shards.append(out.narrow(split, 0, s.shape[split]))
    return DNDarray(shards, x.shape, types.canonical_heat_type(shards[0].dtype), split, x.device, x.comm)


def exchange_halos(x, halo_size: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Every position's halos of a split DNDarray, backing
    ``DNDarray.get_halo`` (heat_tpu/ops/halo.py:138): two lists with one
    ``(halo_size, ...)`` tensor per position, the split axis moved to the
    front; global edges hold zeros, and the caller applies the populated
    positions' rule.  Each halo is a copy, so later writes to the shards do
    not show through it."""
    from ..core.dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"exchange_halos expects a DNDarray, got {type(x)}")
    split = x.split
    chunk = max(x.comm.chunk(x.shape, split, rank=0)[1][split], 1)
    blocks = [_physical(s, split, chunk).movedim(split, 0) for s in x.shards]
    prev, nxt = halo_exchange(blocks, min(halo_size, chunk), axis=0)
    return [p.clone() for p in prev], [q.clone() for q in nxt]
