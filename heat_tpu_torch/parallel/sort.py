"""Sort, top-k and unique along a split axis over the shard list
(counterpart of heat_tpu/parallel/sort.py).

The sort is the JAX package's block odd-even merge-split network: every
position sorts its block, then in ``S`` rounds neighbouring positions
(even pairs, then odd pairs) merge their two blocks and split them again,
the left keeping as many of the lowest elements as it holds.  Each merge
orders by the total key (value, original index), so both partners agree on
ties and the result is the stable sort, independent of the number of
positions.  The blocks keep the chunk rule's sizes throughout (a short or
empty trailing block included: by the 0-1 principle ``S`` rounds still
sort), so the data axis is never gathered.  The JAX package switches to
columnsort on large meshes; both give the same permutation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = [
    "distributed_sort",
    "distributed_topk",
    "ordered_less",
    "searchsorted_left",
    "stable_sort",
    "topk_order",
    "topk_select",
    "unique_compact_sorted",
]


def _parts(t: torch.Tensor):
    if t.is_complex():
        return t.real, t.imag
    return t, torch.zeros_like(t)


def ordered_less(a: torch.Tensor, b: torch.Tensor, or_equal: bool = False) -> torch.Tensor:
    """``a < b`` (``a <= b`` with ``or_equal``), complex values in NumPy's
    lexicographic order: real parts first, then imaginary parts."""
    if not (a.is_complex() or b.is_complex()):
        return torch.le(a, b) if or_equal else torch.lt(a, b)
    (ar, ai), (br, bi) = _parts(a), _parts(b)
    tie = torch.le(ai, bi) if or_equal else torch.lt(ai, bi)
    return torch.lt(ar, br) | (torch.eq(ar, br) & tie)


def stable_sort(t: torch.Tensor, dim: int, descending: bool = False):
    """``torch.sort(..., stable=True)`` as (values, indices), complex values
    in NumPy's lexicographic order (a stable sort by the imaginary parts,
    then one by the real parts)."""
    if not t.is_complex():
        s = torch.sort(t, dim=dim, descending=descending, stable=True)
        return s.values, s.indices
    perm = torch.sort(t.imag, dim=dim, descending=descending, stable=True).indices
    perm = perm.gather(dim, torch.sort(t.real.gather(dim, perm), dim=dim, descending=descending, stable=True).indices)
    return t.gather(dim, perm), perm


def searchsorted_left(sorted_1d: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``torch.searchsorted(sorted_1d, values)`` (the left side), complex
    values in NumPy's order: each value's count of smaller elements, from
    one stable sort of the values placed before the sorted elements."""
    if not sorted_1d.is_complex():
        return torch.searchsorted(sorted_1d, values)
    flat = values.reshape(-1)
    _, perm = stable_sort(torch.cat([flat, sorted_1d.to(flat.dtype)]), 0)
    is_sorted = (perm >= flat.numel()).to(torch.int64)
    before = torch.cumsum(is_sorted, 0) - is_sorted
    pos = torch.empty_like(before)
    pos[perm] = before
    return pos[: flat.numel()].reshape(values.shape)


def _order(keys: torch.Tensor, idx: torch.Tensor, payloads: Sequence[torch.Tensor], descending: bool):
    """Reorder along dim 0 by (key, index): ascending or descending keys,
    ties by ascending index (stable sorts)."""
    perm = torch.argsort(idx, dim=0, stable=True)
    keys, idx = keys.gather(0, perm), idx.gather(0, perm)
    payloads = [p.gather(0, perm) for p in payloads]
    _, perm = stable_sort(keys, 0, descending)
    return keys.gather(0, perm), idx.gather(0, perm), [p.gather(0, perm) for p in payloads]


def distributed_sort(
    shards: Sequence[torch.Tensor], axis: int, descending: bool = False, payloads: Sequence[Sequence[torch.Tensor]] = ()
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[List[torch.Tensor]]]:
    """Sort the shards of an array split along ``axis``
    (heat_tpu/parallel/sort.py:395): returns the sorted shards (stable, NaN
    last ascending and first descending, as ``torch.sort``/``jnp.sort``),
    the original global positions along ``axis`` as int32 shards, and each
    payload (a list of shards aligned with the keys) reordered alike."""
    S = len(shards)
    keys, idx, pays = [], [], []
    off = 0
    for r, s in enumerate(shards):
        k = s.movedim(axis, 0)
        n = k.shape[0]
        i = (torch.arange(n, device=s.device, dtype=torch.int64) + off).reshape([n] + [1] * (k.ndim - 1)).expand(k.shape)
        off += n
        k, i, p = _order(k, i.contiguous(), [q[r].movedim(axis, 0) for q in payloads], descending)
        keys.append(k)
        idx.append(i)
        pays.append(p)
    for t in range(S):
        for a in range(t % 2, S - 1, 2):
            b = a + 1
            na, nb = keys[a].shape[0], keys[b].shape[0]
            if na == 0 or nb == 0:
                continue
            k, i, p = _order(
                torch.cat([keys[a], keys[b]]), torch.cat([idx[a], idx[b]]),
                [torch.cat([x, y]) for x, y in zip(pays[a], pays[b])], descending,
            )
            keys[a], keys[b] = k[:na], k[na:]
            idx[a], idx[b] = i[:na], i[na:]
            pays[a], pays[b] = [x[:na] for x in p], [x[na:] for x in p]
    values = [k.movedim(0, axis).contiguous() for k in keys]
    indices = [i.movedim(0, axis).to(torch.int32).contiguous() for i in idx]
    moved = [[p.movedim(0, axis).contiguous() for p in ps] for ps in pays]
    return values, indices, [[moved[r][j] for r in range(S)] for j in range(len(payloads))]


def _total_order_key(t: torch.Tensor) -> torch.Tensor:
    """An integer key whose order is IEEE totalOrder on floats (−NaN <
    −inf < … < −0 < +0 < … < +inf < +NaN), the order of ``lax.top_k``;
    integers and bools as they are."""
    if not t.dtype.is_floating_point:
        return t.to(torch.int64) if t.dtype == torch.bool else t
    int_dtype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.view(int_dtype)
    return torch.where(bits < 0, bits ^ torch.iinfo(int_dtype).max, bits)


def topk_order(t: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Positions of the top ``k`` along the last dimension of ``t`` in the
    order of ``lax.top_k``: descending in totalOrder, ties by lower
    position; ``largest=False`` ranks the negated floats (inverted
    integers), as the JAX package does."""
    if not largest:
        t = -t if t.dtype.is_floating_point else (~t if t.dtype != torch.bool else t.logical_not())
    return torch.sort(_total_order_key(t), dim=-1, descending=True, stable=True).indices[..., :k]


# elements up to which topk_select sorts whole rows instead of selecting
_SORT_ELEMENTS = 1 << 20


def topk_select(t: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """:func:`topk_order`'s result for a 2-D float ``t`` whose rows are much
    longer than ``k``, without sorting them: ``torch.topk`` selects k + 1,
    and only a row whose k-th and (k+1)-th values are equal (a tie across
    the cut, where ``torch.topk`` may keep any of the equal elements) is
    ranked again by :func:`topk_order`, which reads the host once for all
    such rows.  The selection is then ordered as ``lax.top_k`` orders it.
    Nothing of the row's size is allocated.  A small ``t`` (up to
    ``_SORT_ELEMENTS``) is ranked by :func:`topk_order` directly, with no
    host read."""
    if t.numel() <= _SORT_ELEMENTS:
        return topk_order(t, k, largest)
    m = t.shape[-1]
    vals, idx = torch.topk(t, min(k + 1, m), dim=-1, largest=largest, sorted=True)
    if m > k:
        cut = torch.eq(vals[..., k], vals[..., k - 1]).nonzero().reshape(-1)
        idx = idx[..., :k].clone()
        if cut.numel():
            idx[cut] = topk_order(t[cut], k, largest)
    idx = torch.sort(idx, dim=-1).values
    return idx.gather(-1, topk_order(t.gather(-1, idx), k, largest))


def distributed_topk(shards: Sequence[torch.Tensor], axis: int, k: int, largest: bool = True):
    """Top-k along the split ``axis`` (heat_tpu/parallel/sort.py:380): each
    position ranks its own block, the candidates (at most ``k`` per
    position, with global indices) are joined, and the top ``k`` of them
    are the result, replicated: ``(values, int64 global indices)``."""
    cand_v, cand_i = [], []
    off = 0
    for s in shards:
        v = s.movedim(axis, -1)
        n = v.shape[-1]
        if n:
            sel = topk_order(v, min(k, n), largest)
            cand_v.append(v.gather(-1, sel))
            cand_i.append(sel + off)
        off += n
    v, i = torch.cat(cand_v, dim=-1), torch.cat(cand_i, dim=-1)
    sel = topk_order(v, k, largest)
    return v.gather(-1, sel).movedim(-1, axis), i.gather(-1, sel).to(torch.int64).movedim(-1, axis)


def unique_compact_sorted(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each position's uniques of a sorted 1-D split array
    (heat_tpu/parallel/sort.py:483): an element is kept when it differs
    from its predecessor, which for a block's first element is the last
    element of the nearest non-empty block to its left; NaNs compare equal
    (NumPy's ``equal_nan``)."""
    out, prev = [], None
    for s in shards:
        if s.numel() == 0:
            out.append(s)
            continue
        before = torch.cat([s[:1] if prev is None else prev, s[:-1]])
        same = s == before
        if s.dtype.is_floating_point:
            same = same | (torch.isnan(s) & torch.isnan(before))
        if prev is None:
            same[0] = False
        out.append(s[~same])
        prev = s[-1:]
    return out
