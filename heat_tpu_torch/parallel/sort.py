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

Across processes (``comm=`` a :class:`~heat_tpu_torch.parallel.mesh.MeshComm`
that spans them; ``shards`` then hold :class:`RemoteShard` entries for the other
processes' positions) each process computes its own positions' blocks: in a
network round whose pair (a, a+1) straddles two processes, the two exchange
their blocks (keys, indices, payloads) and both compute the same merge,
each keeping its half, as MPI's merge-split does; columnsort's deal, undeal
and final cut are all-to-alls, and its merge rounds trade whole columns.
Every move goes through :func:`collectives.exchange`, one a stage, which
every process enters.  Top-k gathers the candidates, unique the blocks'
last elements and the uniques.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .mesh import RemoteShard

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


def _positions(S: int, comm) -> Tuple[int, ...]:
    return tuple(range(S)) if comm is None else comm.local_positions


def _trade(comm, sends: Dict[tuple, list], rows: Dict[tuple, int], like: list, dev) -> dict:
    """Blocks between positions of different processes, one exchange:
    ``sends`` maps (source, destination) to this process's list of arrays
    for it, ``rows`` maps (source, destination) to the rows it receives
    (the trailing shapes and dtypes are ``like``'s).  Returns the received
    lists by (source, destination).  No exchange without a comm that spans
    processes."""
    from . import collectives

    if comm is None or not comm.spans_processes:
        return {}
    flat = {key + (t,): a for key, arrs in sends.items() for t, a in enumerate(arrs)}
    specs = {key + (t,): ((n,) + tuple(a.shape[1:]), a.dtype) for key, n in rows.items() for t, a in enumerate(like)}
    got = collectives.exchange(flat, specs, comm, dev)
    return {key: [got[key + (t,)] for t in range(len(like))] for key in rows}


def _crosses(comm, a: int, b: int) -> bool:
    return comm is not None and comm.process_index(a) != comm.process_index(b)


def distributed_sort(
    shards: Sequence[torch.Tensor], axis: int, descending: bool = False, payloads: Sequence[Sequence[torch.Tensor]] = (),
    method: str = "auto", comm=None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[List[torch.Tensor]]]:
    """Sort the shards of an array split along ``axis``
    (heat_tpu/parallel/sort.py:395): returns the sorted shards (stable, NaN
    last ascending and first descending, as ``torch.sort``/``jnp.sort``),
    the original global positions along ``axis`` as int32 shards, and each
    payload (a list of shards aligned with the keys) reordered alike.
    ``method``: ``"auto"`` and ``"network"`` take the odd-even network (on
    one card it is never slower; module docstring), ``"columnsort"`` takes
    columnsort, which raises below Leighton's bound
    (:func:`columnsort_applicable`).  With a ``comm`` that spans processes
    the entries of other processes' positions are :class:`RemoteShard` entries
    in and out."""
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
        args = (shards, axis, descending, payloads, per)
        return _columnsort(*args) if comm is None else _columnsort(*args, comm)
    if method != "network":
        raise ValueError(f"unknown sort method {method!r}")
    local = _positions(S, comm)
    sizes = [int(s.shape[axis]) for s in shards]
    starts = [sum(sizes[:r]) for r in range(S)]
    blocks = {}
    for r in local:
        k = shards[r].movedim(axis, 0)
        n = k.shape[0]
        i = (torch.arange(n, device=k.device, dtype=torch.int64) + starts[r]).reshape([n] + [1] * (k.ndim - 1)).expand(k.shape)
        k, i, p = _order(k, i.contiguous(), [q[r].movedim(axis, 0) for q in payloads], descending)
        blocks[r] = [k, i] + p
    like = blocks[local[0]]
    for t in range(S):
        pairs = [(a, a + 1) for a in range(t % 2, S - 1, 2) if sizes[a] and sizes[a + 1]]
        got = {}
        if any(_crosses(comm, a, b) for a, b in pairs):
            sends, rows = {}, {}
            for a, b in pairs:
                if _crosses(comm, a, b):
                    mine, other = (a, b) if a in local else (b, a) if b in local else (None, None)
                    if mine is not None:
                        sends[(mine, other)] = blocks[mine]
                        rows[(other, mine)] = sizes[other]
            got = _trade(comm, sends, rows, like, like[0].device)
        for a, b in pairs:
            if a not in local and b not in local:
                continue
            A = blocks[a] if a in local else got[(a, b)]
            B = blocks[b] if b in local else got[(b, a)]
            na = sizes[a]
            k, i, p = _order(torch.cat([A[0], B[0]]), torch.cat([A[1], B[1]]),
                             [torch.cat([x, y]) for x, y in zip(A[2:], B[2:])], descending)
            if a in local:
                blocks[a] = [k[:na], i[:na]] + [x[:na] for x in p]
            if b in local:
                blocks[b] = [k[na:], i[na:]] + [x[na:] for x in p]
    return _finish(blocks, shards, axis, comm, payloads)


def _finish(blocks: dict, shards, axis: int, comm, payloads):
    """The sorted (values, int32 indices, payloads) shards from the blocks
    of this process's positions (keys, indices, payloads along dim 0)."""
    S = len(shards)

    def placed(t, dtype, src):
        return [blocks[r][t].movedim(0, axis).to(dtype).contiguous() if r in blocks
                else RemoteShard(r, tuple(src[r].shape), dtype, src[r].device) for r in range(S)]

    values = placed(0, shards[_positions(S, comm)[0]].dtype, shards)
    indices = placed(1, torch.int32, shards)
    moved = [placed(2 + j, payloads[j][_positions(S, comm)[0]].dtype, payloads[j]) for j in range(len(payloads))]
    return values, indices, moved


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


def _columnsort(shards, axis: int, descending: bool, payloads, per: int, comm=None):
    """Leighton's columnsort over the positions' blocks
    (heat_tpu/parallel/sort.py:196): each position's block (``per`` rows by
    the chunk rule, padded to ``per_pad = b·S`` with flagged pads) is a
    column; sort, deal (row i of column j to column i mod S, row j·b +
    i//S), sort, undeal, sort, then merge-split rounds of neighbours (even,
    odd, even), each keeping ``per_pad`` rows; the columns then hold the
    sorted sequence, real elements first, and are cut to the chunk rule.
    Across processes the deal, the undeal and the cut are all-to-alls and
    the merge rounds trade whole columns (one exchange a stage)."""
    S = len(shards)
    b = -(-per // S)
    per_pad = b * S
    local = _positions(S, comm)
    sizes = [int(s.shape[axis]) for s in shards]
    starts = [sum(sizes[:r]) for r in range(S)]
    n_total = sum(sizes)
    cols = {}
    for r in local:
        sh = shards[r]
        k = sh.movedim(axis, 0)
        n, rest, dev = k.shape[0], tuple(k.shape[1:]), sh.device
        lead = (per_pad,) + (1,) * len(rest)
        idx = (torch.arange(per_pad, device=dev, dtype=torch.int64) + starts[r]).reshape(lead).expand((per_pad,) + rest)
        pad = (torch.arange(per_pad, device=dev) >= n).reshape(lead).expand((per_pad,) + rest)
        grow = lambda t: torch.cat([t, t.new_zeros((per_pad - n,) + tuple(t.shape[1:]))]) if per_pad > n else t
        cols[r] = _order_padded([grow(k), idx.contiguous(), pad.contiguous()] + [grow(q[r].movedim(axis, 0)) for q in payloads],
                                descending)
    like = cols[local[0]]
    dev = like[0].device
    width = len(like)

    def all_to_all(piece, rows):
        """Column c's new pieces from every column j (``piece(j, c)``, a
        list of arrays of ``rows(j, c)`` rows), in j order."""
        sends = {(j, c): piece(j, c) for j in local for c in range(S) if _crosses(comm, j, c)}
        got = _trade(comm, sends, {(j, c): rows(j, c) for c in local for j in range(S) if _crosses(comm, j, c)},
                     like, dev)
        return {c: [got[(j, c)] if (j, c) in got else piece(j, c) for j in range(S)] for c in local}

    # deal: column c gathers row block [:, c] of every column's (b, S) view
    dealt = all_to_all(lambda j, c: [a.reshape((b, S) + tuple(a.shape[1:]))[:, c] for a in cols[j]], lambda j, c: b)
    cols = {c: _order_padded([torch.cat([p[t] for p in dealt[c]]) for t in range(width)], descending) for c in local}
    # undeal: column j interleaves rows [j·b, (j+1)·b) of every column
    back = all_to_all(lambda c, j: [a[j * b:(j + 1) * b] for a in cols[c]], lambda c, j: b)
    cols = {j: _order_padded([torch.stack([p[t] for p in back[j]], dim=1).reshape((per_pad,) + tuple(like[t].shape[1:]))
                              for t in range(width)], descending) for j in local}
    for parity in (0, 1, 0):
        pairs = [(a, a + 1) for a in range(parity, S - 1, 2)]
        sends, rows = {}, {}
        for a, c in pairs:
            if _crosses(comm, a, c):
                mine, other = (a, c) if a in local else (c, a) if c in local else (None, None)
                if mine is not None:
                    sends[(mine, other)] = cols[mine]
                    rows[(other, mine)] = per_pad
        got = _trade(comm, sends, rows, like, dev) if any(_crosses(comm, a, c) for a, c in pairs) else {}
        for a, c in pairs:
            if a not in local and c not in local:
                continue
            A = cols[a] if a in local else got[(a, c)]
            B = cols[c] if c in local else got[(c, a)]
            merged = _order_padded([torch.cat([x, y]) for x, y in zip(A, B)], descending)
            if a in local:
                cols[a] = [m[:per_pad] for m in merged]
            if c in local:
                cols[c] = [m[per_pad:] for m in merged]
    # the real elements lead the column sequence: cut it by the chunk rule
    bounds = [(min(r * per, n_total), min((r + 1) * per, n_total)) for r in range(S)]

    def span(c, r):
        lo, hi = bounds[r]
        return max(lo - c * per_pad, 0), max(min(hi - c * per_pad, per_pad), 0)

    def cut(c, r):
        a0, a1 = span(c, r)
        return [a[a0:max(a0, a1)] for a in cols[c]]

    pieces = all_to_all(cut, lambda c, r: max(0, span(c, r)[1] - span(c, r)[0]))
    blocks = {r: [torch.cat([p[t] for p in pieces[r]]) for t in range(width)] for r in local}
    blocks = {r: [bl[0], bl[1]] + bl[3:] for r, bl in blocks.items()}
    return _finish(blocks, shards, axis, comm, payloads)


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


def distributed_topk(shards: Sequence[torch.Tensor], axis: int, k: int, largest: bool = True, comm=None):
    """Top-k along the split ``axis`` (heat_tpu/parallel/sort.py:380): each
    position ranks its own block, the candidates (at most ``k`` per
    position, with global indices) are joined, and the top ``k`` of them
    are the result, replicated: ``(values, int64 global indices)``.  Across
    processes the candidates are gathered through the exchange, in
    position order."""
    from . import collectives

    S = len(shards)
    local = _positions(S, comm)
    sizes = [int(s.shape[axis]) for s in shards]
    cand_v, cand_i = [], []
    for r in local:
        v = shards[r].movedim(axis, -1)
        sel = topk_order(v, min(k, sizes[r]), largest)
        cand_v.append(v.gather(-1, sel))
        cand_i.append(sel + sum(sizes[:r]))
    if comm is not None and comm.spans_processes:
        lengths = [min(k, n) for n in sizes]
        v = collectives.all_gather(cand_v, dim=-1, comm=comm, lengths=lengths)[0]
        i = collectives.all_gather(cand_i, dim=-1, comm=comm, lengths=lengths)[0]
    else:
        v, i = torch.cat(cand_v, dim=-1), torch.cat(cand_i, dim=-1)
    sel = topk_order(v, k, largest)
    return v.gather(-1, sel).movedim(-1, axis), i.gather(-1, sel).to(torch.int64).movedim(-1, axis)


def unique_compact_sorted(shards: Sequence[torch.Tensor], comm=None) -> List[torch.Tensor]:
    """Each position's uniques of a sorted 1-D split array
    (heat_tpu/parallel/sort.py:483): an element is kept when it differs
    from its predecessor, which for a block's first element is the last
    element of the nearest non-empty block to its left; NaNs compare equal
    (NumPy's ``equal_nan``).  Across processes the blocks' last elements
    are gathered first; the result holds this process's positions'
    uniques."""
    from . import collectives

    S = len(shards)
    local = _positions(S, comm)
    sizes = [int(s.shape[0]) for s in shards]
    lasts = {r: shards[r][-1:] for r in local}
    if comm is not None and comm.spans_processes:
        gathered = collectives.all_gather([lasts[r] for r in local], comm=comm,
                                          lengths=[min(n, 1) for n in sizes])[0]
        at = 0
        for r in range(S):
            if sizes[r]:
                lasts[r] = gathered[at: at + 1]
                at += 1
    out = []
    for r in local:
        s = shards[r]
        if s.numel() == 0:
            out.append(s)
            continue
        left = [q for q in range(r) if sizes[q]]
        prev = lasts[left[-1]] if left else None
        before = torch.cat([s[:1] if prev is None else prev.to(s.device), s[:-1]])
        same = s == before
        if s.dtype.is_floating_point:
            same = same | (torch.isnan(s) & torch.isnan(before))
        if prev is None:
            same[0] = False
        out.append(s[~same])
    return out
