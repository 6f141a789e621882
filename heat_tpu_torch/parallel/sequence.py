"""Sequence parallelism: ring attention and Ulysses all-to-all (counterpart
of heat_tpu/parallel/sequence.py).

Under the single controller every position's shard is in hand, so the
shard-level functions take one tensor per position and return one per
position, as their JAX counterparts do inside ``shard_map``:

* :func:`ring_attention` — each position keeps its Q shard while the K/V
  shards rotate one position down the ring (``ring_shift``); the blocks'
  online-softmax statistics are merged with the flash-attention combine
  rule.  Plain torch, as the JAX package's is plain jnp.
* :func:`ulysses_attention` — one ``all_to_all`` swaps the sharded
  dimension from sequence to heads, each position runs full-sequence
  attention for its head group through K3 (:func:`flash_attention`), and
  the inverse ``all_to_all`` restores the sequence split.

:func:`sequence_parallel_attention` is the array-level entry: it cuts the
sequence of (batch, heads, seq, head_dim) tensors over a
:class:`~heat_tpu_torch.parallel.mesh.MeshComm`, or over one axis of a
:class:`~heat_tpu_torch.parallel.mesh.Mesh` with the batch cut over its
other axes (heat_tpu's ``dp`` axis), and joins the result.  On a mesh whose
positions belong to several processes each process computes its own
positions: the K/V blocks and the Ulysses pieces cross through
:func:`~heat_tpu_torch.parallel.collectives.exchange`, the replicated
inputs are cut (their gradients all-gathered) and the output joined on
every process (:func:`~heat_tpu_torch.parallel.collectives.cut` /
:func:`~heat_tpu_torch.parallel.collectives.join`), in one
:func:`~heat_tpu_torch.parallel.collectives.grad_chain`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import flash_attention
from . import collectives
from .mesh import Mesh, MeshComm, sanitize_comm

__all__ = ["ring_attention", "ulysses_attention", "sequence_parallel_attention"]

_NEG_INF = -1e30


def _block_stats(q, k, v, scale, mask):
    """Unnormalised attention of one (Q shard, K/V shard) pair: running max
    m (..., sq, 1), normaliser l (..., sq, 1) and output o (..., sq, d)
    (heat_tpu/parallel/sequence.py:46)."""
    s = torch.einsum("...qd,...kd->...qk", q, k).to(torch.float32) * scale
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    # guard fully masked rows
    m_safe = torch.clamp_min(m, _NEG_INF / 2)
    p = torch.exp(s - m_safe)
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32))
    return m_safe, l, o


def _combine(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials (heat_tpu/parallel/sequence.py:63)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1 + o2 * a2


def _permute(blocks: Dict[int, torch.Tensor], pairs: Sequence[Tuple[int, int]], comm: MeshComm) -> Dict[int, torch.Tensor]:
    """Position ``dst`` receives position ``src``'s block for each pair
    (blocks of one shape), through the exchange: a pair of this process
    passes its block through."""
    like = next(iter(blocks.values()))
    local = set(comm.local_positions)
    got = collectives.exchange({(s, d): blocks[s] for s, d in pairs if s in local},
                               {(s, d): (tuple(like.shape), like.dtype) for s, d in pairs if d in local},
                               comm, like.device)
    return {d: got[(s, d)] for s, d in pairs if d in local}


def _ring(qs: Dict[int, torch.Tensor], ks: Dict[int, torch.Tensor], vs: Dict[int, torch.Tensor], groups, comm,
          causal: bool, scale: Optional[float]) -> Dict[int, torch.Tensor]:
    """Ring attention over each ring of ``groups`` (lists of positions in
    sequence order) for this process's positions (the dicts' keys): at
    step r position ``g[i]`` holds the K/V block of ``g[(i + r) mod n]``,
    and the global sequence offsets drive the causal mask."""
    where = {p: (g, i) for g in groups for i, p in enumerate(g)}
    like = next(iter(qs.values()))
    sq, sk, d = like.shape[-2], next(iter(ks.values())).shape[-2], like.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = like.device
    state = {}
    for p, q in qs.items():
        bshape = tuple(q.shape[:-2])
        state[p] = (
            torch.full(bshape + (sq, 1), _NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros(bshape + (sq, 1), dtype=torch.float32, device=q.device),
            torch.zeros(bshape + (sq, d), dtype=torch.float32, device=q.device),
        )
    kb, vb = dict(ks), dict(vs)
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    # K/V move one position down each ring: g[i] -> g[i - 1]
    pairs = [(g[i], g[i - 1]) for g in groups for i in range(len(g))]
    n = len(groups[0])
    for r in range(n):
        for p in qs:
            g, i = where[p]
            src = (i + r) % n
            if causal:
                mask = (i * sq + rows) >= (src * sk + cols)
            else:
                mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
            mb, lb, ob = _block_stats(qs[p], kb[p], vb[p], scale, mask)
            state[p] = _combine(*state[p], mb, lb, ob)
        if r < n - 1:
            kb, vb = _permute(kb, pairs, comm), _permute(vb, pairs, comm)
    out = {}
    for p, q in qs.items():
        _, l, o = state[p]
        l = torch.where(l == 0.0, torch.ones((), device=l.device), l)  # fully masked rows give 0
        out[p] = (o / l).to(q.dtype)
    return out


def _group_all_to_all(parts: Dict[int, torch.Tensor], groups, comm, split_axis: int,
                      concat_axis: int) -> Dict[int, torch.Tensor]:
    """``all_to_all`` within each group: member i cuts its block into n
    pieces along ``split_axis`` and sends piece j to member j, which joins
    what it receives along ``concat_axis`` in member order; one exchange
    for every group."""
    local = set(comm.local_positions)
    like = next(iter(parts.values()))
    n = len(groups[0])
    if like.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of size {like.shape[split_axis]} does not divide over "
                         f"{n} positions")
    piece = list(like.shape)
    piece[split_axis] //= n
    sends, specs = {}, {}
    for g in groups:
        for i, src in enumerate(g):
            for j, dst in enumerate(g):
                if src in local:
                    sends[(src, dst)] = parts[src].narrow(split_axis, j * piece[split_axis], piece[split_axis])
                if dst in local:
                    specs[(src, dst)] = (tuple(piece), like.dtype)
    got = collectives.exchange(sends, specs, comm, like.device)
    return {dst: torch.cat([got[(src, dst)] for src in g], dim=concat_axis) for g in groups for dst in g
            if dst in local}


def _ulysses(qs, ks, vs, groups, comm, causal: bool, scale: Optional[float]) -> Dict[int, torch.Tensor]:
    """Ulysses within each group of positions: heads swap in for the
    sequence, K3 runs once a position on its head group over the group's
    whole sequence, and the inverse exchange restores the sequence cut."""
    def seq_to_head(parts):
        # (h, s_loc, d) -> (h/n, s_glob, d)
        return _group_all_to_all(parts, groups, comm, 0, 1)

    qh, kh, vh = seq_to_head(qs), seq_to_head(ks), seq_to_head(vs)
    out = {p: flash_attention(qh[p], kh[p], vh[p], causal=causal, scale=scale) for p in qh}
    return _group_all_to_all(out, groups, comm, 1, 0)


def ring_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> List[torch.Tensor]:
    """Exact attention over a sequence cut into one shard per position
    (heat_tpu/parallel/sequence.py:71).

    ``qs[i], ks[i], vs[i]``: ``(..., seq_local, head_dim)``; position i
    holds global rows ``[i*seq_local, (i+1)*seq_local)``.  At step r the K/V
    block on position i came from position (i + r) mod N, and the global
    positions drive the causal mask."""
    n = len(qs)
    comm = MeshComm(n)
    out = _ring(dict(enumerate(qs)), dict(enumerate(ks)), dict(enumerate(vs)), [list(range(n))], comm, causal, scale)
    return [out[i] for i in range(n)]


def ulysses_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> List[torch.Tensor]:
    """All-to-all sequence parallelism (heat_tpu/parallel/sequence.py:128).

    ``qs[i]`` etc.: ``(heads, seq_local, head_dim)`` with heads divisible by
    the number of positions.  K3 runs once per position, on its head group
    over the whole sequence."""
    n = len(qs)
    h = qs[0].shape[0]
    if h % n:
        raise ValueError(f"heads {h} not divisible by mesh axis size {n}")
    out = _ulysses(dict(enumerate(qs)), dict(enumerate(ks)), dict(enumerate(vs)), [list(range(n))], MeshComm(n),
                   causal, scale)
    return [out[i] for i in range(n)]


def _layout(comm, axis_name: Optional[str], shape) -> Tuple[MeshComm, list, Dict[int, tuple]]:
    """(the positions' flat comm, the sequence rings, each position's
    (batch, heads, seq, head_dim) block) for a :class:`MeshComm` (the
    sequence over all its positions) or a :class:`Mesh` with the sequence
    over ``axis_name`` and the batch over the other axes (heat_tpu's
    ``P(other, None, axis_name, None)``)."""
    b, _, s, _ = shape
    if isinstance(comm, Mesh):
        mesh = comm
        if axis_name not in mesh.axis_names:
            raise ValueError(f"axis {axis_name!r} not in mesh axes {mesh.axis_names}")
        ax = mesh.axis_names.index(axis_name)
        ids = np.moveaxis(mesh.devices, ax, -1)
        n_sp = ids.shape[-1]
        rings = [[int(p) for p in row] for row in ids.reshape(-1, n_sp)]
        flat = MeshComm(Mesh(np.arange(mesh.devices.size), ("positions",), mesh.per_process), split_axis="positions")
    else:
        flat = sanitize_comm(comm)
        n_sp = flat.size
        rings = [list(range(n_sp))]
    n_dp = len(rings)
    if b % n_dp:
        raise ValueError(f"batch {b} does not divide over the {n_dp} positions of the mesh's other axes")
    if s % n_sp:
        raise ValueError(f"the sequence of {s} does not divide over {n_sp} positions")
    bb, sb = b // n_dp, s // n_sp
    blocks = {p: (slice(g * bb, (g + 1) * bb), slice(None), slice(i * sb, (i + 1) * sb), slice(None))
              for g, ring in enumerate(rings) for i, p in enumerate(ring)}
    return flat, rings, blocks


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm=None,
    axis_name: Optional[str] = None,
    *,
    causal: bool = False,
    strategy: str = "ring",
) -> torch.Tensor:
    """Attention with the sequence dimension cut over ``comm``'s positions
    (heat_tpu/parallel/sequence.py:163).

    ``q, k, v``: ``(batch, heads, seq, head_dim)``, replicated (the same
    tensors on every process).  ``comm`` is a :class:`MeshComm` (the
    sequence over all its positions, the batch whole) or a :class:`Mesh`
    with ``axis_name`` (the sequence over that axis, the batch over the
    mesh's other axes, as heat_tpu's ``dp``).  The cut dimensions must
    divide evenly, as ``shard_map`` requires.  ``strategy`` is ``"ring"``
    or ``"ulysses"``; Ulysses folds batch into heads, so a position's
    batch·heads must divide over the sequence axis.  On a mesh that spans
    processes each process computes its positions and the result is
    joined on every process; gradients reach ``q``, ``k`` and ``v`` whole
    on every process."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"sequence_parallel_attention takes (batch, heads, seq, head_dim), got {q.ndim}-D")
    for name, t in (("k", k), ("v", v)):
        if t.shape[:2] != q.shape[:2] or t.shape[3] != q.shape[3]:
            raise ValueError(f"{name} of shape {tuple(t.shape)} does not match q's {tuple(q.shape)}")
    flat, rings, blocks = _layout(comm, axis_name, tuple(q.shape))
    kv_blocks = blocks if k.shape == q.shape else _layout(comm, axis_name, tuple(k.shape))[2]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    with collectives.grad_chain(grad):
        local = flat.local_positions
        qs, ks, vs = (dict(zip(local, collectives.cut(t, bl, flat)))
                      for t, bl in ((q, blocks), (k, kv_blocks), (v, kv_blocks)))
        if strategy == "ring":
            out = _ring(qs, ks, vs, rings, flat, causal, None)
        else:
            b, h = next(iter(qs.values())).shape[:2]
            if (b * h) % len(rings[0]):
                raise ValueError(f"heads {b * h} not divisible by mesh axis size {len(rings[0])}")

            def fold(parts):
                return {p: t.reshape(b * h, t.shape[2], t.shape[3]) for p, t in parts.items()}

            out = _ulysses(fold(qs), fold(ks), fold(vs), rings, flat, causal, None)
            out = {p: o.reshape(b, h, o.shape[1], o.shape[2]) for p, o in out.items()}
        return collectives.join([out[p] for p in local], blocks, tuple(q.shape), flat)
