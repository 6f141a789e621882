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
sort), so the data axis is never gathered.  ``method="columnsort"``
takes Leighton's columnsort instead, on six positions or more with blocks
of at least ``2(S-1)²`` rows: sort each block (a column), deal it
round-robin over the columns, sort, undeal, sort, then three merge-split
rounds of neighbours; its columns are padded to a multiple of ``S`` rows
with flagged pads that sort to the tail, and the sorted columns are cut
back to the chunk rule.  Both give the same permutation.  The JAX package's
``"auto"`` takes columnsort wherever it applies, since on a TPU each
network round is an exchange between chips; here every position lies on
one card, where columnsort took 1.9–2.3× the network's time at 784 and
1e5 rows over 8 positions and the same at 1e7 (``chip_smoke.py``'s
``sort_method_paths`` on an H100), so ``"auto"`` takes the network.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = [
    "columnsort_applicable",
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


def columnsort_applicable(nshards: int, per: int) -> bool:
    """Leighton's bound (heat_tpu/parallel/sort.py:184): a column of ``r``
    rows over ``s`` columns sorts in the 5-step schedule iff ``r >=
    2(s-1)²``, ``r`` the block padded to a multiple of ``s``; below six
    positions the network's rounds are as few."""
    per_pad = -(-per // nshards) * nshards
    return nshards >= 6 and per_pad >= 2 * (nshards - 1) ** 2


def distributed_sort(
    shards: Sequence[torch.Tensor], axis: int, descending: bool = False, payloads: Sequence[Sequence[torch.Tensor]] = (),
    method: str = "auto",
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[List[torch.Tensor]]]:
    """Sort the shards of an array split along ``axis``
    (heat_tpu/parallel/sort.py:395): returns the sorted shards (stable, NaN
    last ascending and first descending, as ``torch.sort``/``jnp.sort``),
    the original global positions along ``axis`` as int32 shards, and each
    payload (a list of shards aligned with the keys) reordered alike.
    ``method``: ``"auto"`` and ``"network"`` take the odd-even network (on
    one card it is never slower; module docstring), ``"columnsort"`` takes
    columnsort, which raises below Leighton's bound
    (:func:`columnsort_applicable`)."""
    S = len(shards)
    per = max(s.shape[axis] for s in shards) if S else 0
    if method == "auto":
        method = "network"
    if method == "columnsort":
        per_pad = -(-per // S) * S
        if per_pad < 2 * (S - 1) ** 2:
            raise ValueError(
                f"columnsort needs a padded block of >= 2(s-1)^2 = {2 * (S - 1) ** 2} rows per shard, "
                f"got {per_pad}; use method='network'"
            )
        return _columnsort(shards, axis, descending, payloads, per)
    if method != "network":
        raise ValueError(f"unknown sort method {method!r}")
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


def _order_padded(arrs: List[torch.Tensor], descending: bool) -> List[torch.Tensor]:
    """Reorder ``[keys, idx, pad, *payloads]`` along dim 0 by the total key
    (pad flag, key, index): real elements first, ordered as :func:`_order`
    orders them; pads after."""
    perm = torch.argsort(arrs[1], dim=0, stable=True)
    arrs = [a.gather(0, perm) for a in arrs]
    _, perm = stable_sort(arrs[0], 0, descending)
    arrs = [a.gather(0, perm) for a in arrs]
    perm = torch.argsort(arrs[2].to(torch.uint8), dim=0, stable=True)
    return [a.gather(0, perm) for a in arrs]


def _columnsort(shards, axis: int, descending: bool, payloads, per: int):
    """Leighton's columnsort over the positions' blocks
    (heat_tpu/parallel/sort.py:196): each position's block (``per`` rows by
    the chunk rule, padded to ``per_pad = b·S`` with flagged pads) is a
    column; sort, deal (row i of column j to column i mod S, row j·b +
    i//S), sort, undeal, sort, then merge-split rounds of neighbours (even,
    odd, even), each keeping ``per_pad`` rows; the columns then hold the
    sorted sequence, real elements first, and are cut to the chunk rule."""
    S = len(shards)
    b = -(-per // S)
    per_pad = b * S
    cols, off = [], 0
    for r, sh in enumerate(shards):
        k = sh.movedim(axis, 0)
        n, rest, dev = k.shape[0], tuple(k.shape[1:]), sh.device
        lead = (per_pad,) + (1,) * len(rest)
        idx = (torch.arange(per_pad, device=dev, dtype=torch.int64) + off).reshape(lead).expand((per_pad,) + rest)
        pad = (torch.arange(per_pad, device=dev) >= n).reshape(lead).expand((per_pad,) + rest)
        grow = lambda t: torch.cat([t, t.new_zeros((per_pad - n,) + tuple(t.shape[1:]))]) if per_pad > n else t
        cols.append([grow(k), idx.contiguous(), pad.contiguous()] + [grow(q[r].movedim(axis, 0)) for q in payloads])
        off += n
    n_total = off
    cols = [_order_padded(c, descending) for c in cols]
    width = len(cols[0])
    # deal: column c gathers row block [:, c] of every column's (b, S) view
    views = [[a.reshape((b, S) + tuple(a.shape[1:])) for a in c] for c in cols]
    cols = [[torch.cat([views[j][t][:, c] for j in range(S)]) for t in range(width)] for c in range(S)]
    cols = [_order_padded(c, descending) for c in cols]
    # undeal: column j interleaves rows [j·b, (j+1)·b) of every column
    cols = [[torch.stack([cols[c][t][j * b:(j + 1) * b] for c in range(S)], dim=1).reshape(cols[0][t].shape)
             for t in range(width)] for j in range(S)]
    cols = [_order_padded(c, descending) for c in cols]
    for parity in (0, 1, 0):
        for a in range(parity, S - 1, 2):
            merged = _order_padded([torch.cat([x, y]) for x, y in zip(cols[a], cols[a + 1])], descending)
            cols[a], cols[a + 1] = [m[:per_pad] for m in merged], [m[per_pad:] for m in merged]
    # the real elements lead the column sequence: cut it by the chunk rule
    outs = [[] for _ in range(width)]
    start = 0
    for r in range(S):
        end = min(start + per, n_total)
        for t in range(width):
            pieces = [cols[c][t][max(start - c * per_pad, 0):max(min(end - c * per_pad, per_pad), 0)]
                      for c in range(start // per_pad, S) if c * per_pad < end]
            outs[t].append(torch.cat(pieces) if pieces else cols[0][t][:0])
        start = end
    values = [k.movedim(0, axis).contiguous() for k in outs[0]]
    indices = [i.movedim(0, axis).to(torch.int32).contiguous() for i in outs[1]]
    moved = [[p.movedim(0, axis).contiguous() for p in outs[3 + j]] for j in range(len(payloads))]
    return values, indices, moved


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
