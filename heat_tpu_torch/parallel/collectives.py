"""Collectives over a list of shards, one tensor per mesh position
(counterpart of heat_tpu/parallel/collectives.py).

Under the single controller every position's tensor is in hand, so a
collective is a plain operation over the list.  Each returns one result per
position, as a collective inside ``shard_map`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .sort import ordered_less

__all__ = ["psum", "pmin", "pmax", "all_gather", "all_to_all", "ppermute", "ring_shift", "bcast", "exscan"]


def _to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce sum: every position receives the sum of all parts."""
    total = parts[0]
    for p in parts[1:]:
        total = total + _to(p, total)
    return [_to(total, p) for p in parts]


def pmin(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce elementwise minimum (complex values in NumPy's
    lexicographic order)."""
    low = parts[0]
    for p in parts[1:]:
        p = _to(p, low)
        low = torch.where(ordered_less(p, low), p, low) if low.is_complex() else torch.minimum(low, p)
    return [_to(low, p) for p in parts]


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce elementwise maximum (complex values in NumPy's
    lexicographic order)."""
    high = parts[0]
    for p in parts[1:]:
        p = _to(p, high)
        high = torch.where(ordered_less(high, p), p, high) if high.is_complex() else torch.maximum(high, p)
    return [_to(high, p) for p in parts]


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
    """Concatenate every position's block along ``dim``, on every position."""
    whole = torch.cat([_to(p, parts[0]) for p in parts], dim=dim)
    return [_to(whole, p) for p in parts]


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """Tiled all-to-all (heat_tpu/parallel/collectives.py:124): each
    position cuts its block into N equal pieces along ``split_axis`` and
    sends piece j to position j; position i concatenates the pieces it
    receives along ``concat_axis``, in the order of their sources."""
    n = len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size {p.shape[split_axis]} does not divide over {n} positions")
    pieces = [p.split(p.shape[split_axis] // n, dim=split_axis) for p in parts]
    return [torch.cat([_to(pieces[j][i], parts[i]) for j in range(n)], dim=concat_axis) for i in range(n)]


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """General permutation over the positions (``lax.ppermute``, under
    heat_tpu/parallel/collectives.py:132): for each ``(src, dst)`` pair
    position ``dst`` receives position ``src``'s block; a position that no
    pair names receives zeros.  No position may receive twice."""
    n = len(parts)
    out: List[Optional[torch.Tensor]] = [None] * n
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"ppermute: pair ({src}, {dst}) is outside {n} positions")
        if out[dst] is not None:
            raise ValueError(f"ppermute: position {dst} receives twice")
        out[dst] = _to(parts[src], parts[dst])
    return [torch.zeros_like(parts[j]) if o is None else o for j, o in enumerate(out)]


def ring_shift(parts: Sequence[torch.Tensor], shift: int = 1) -> List[torch.Tensor]:
    """Pass each position's block ``shift`` positions up the ring
    (heat_tpu/parallel/collectives.py:132): position (i + shift) mod N
    receives position i's block."""
    n = len(parts)
    return ppermute(parts, [(i, (i + shift) % n) for i in range(n)])


def exscan(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Exclusive prefix sum over the positions
    (heat_tpu/parallel/collectives.py:155): position r receives the sum of
    the blocks of positions 0 .. r-1, position 0 zeros."""
    out, run = [], torch.zeros_like(parts[0])
    for p in parts:
        out.append(_to(run, p))
        run = run + _to(p, run)
    return out


def bcast(parts: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
    """Every position receives the ``root`` position's tensor."""
    return [_to(parts[root], p) for p in parts]
