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
:class:`~heat_tpu_torch.parallel.mesh.MeshComm` and joins the result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.attention import flash_attention
from .collectives import all_to_all, ring_shift
from .mesh import MeshComm, sanitize_comm

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
    sq = qs[0].shape[-2]
    sk = ks[0].shape[-2]
    d = qs[0].shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = qs[0].device
    state = []
    for q in qs:
        bshape = tuple(q.shape[:-2])
        state.append((
            torch.full(bshape + (sq, 1), _NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros(bshape + (sq, 1), dtype=torch.float32, device=q.device),
            torch.zeros(bshape + (sq, d), dtype=torch.float32, device=q.device),
        ))
    kb, vb = list(ks), list(vs)
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    for r in range(n):
        for i in range(n):
            src = (i + r) % n
            if causal:
                mask = (i * sq + rows) >= (src * sk + cols)
            else:
                mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
            mb, lb, ob = _block_stats(qs[i], kb[i], vb[i], scale, mask)
            state[i] = _combine(*state[i], mb, lb, ob)
        if r < n - 1:
            # K/V move one position down the ring: (i -> i - 1)
            kb = ring_shift(kb, shift=-1)
            vb = ring_shift(vb, shift=-1)
    out = []
    for q, (_, l, o) in zip(qs, state):
        l = torch.where(l == 0.0, torch.ones((), device=l.device), l)  # fully masked rows give 0
        out.append((o / l).to(q.dtype))
    return out


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

    def seq_to_head(parts):
        # (h, s_loc, d) -> (h/n, s_glob, d)
        return all_to_all(parts, split_axis=0, concat_axis=1)

    qh, kh, vh = seq_to_head(qs), seq_to_head(ks), seq_to_head(vs)
    out = [flash_attention(q, k, v, causal=causal, scale=scale) for q, k, v in zip(qh, kh, vh)]
    return all_to_all(out, split_axis=1, concat_axis=0)


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Optional[MeshComm] = None,
    *,
    causal: bool = False,
    strategy: str = "ring",
) -> torch.Tensor:
    """Attention with the sequence dimension cut over ``comm``'s positions
    (heat_tpu/parallel/sequence.py:163).

    ``q, k, v``: ``(batch, heads, seq, head_dim)``; the sequence must divide
    evenly over the positions, as ``shard_map`` requires.  ``strategy`` is
    ``"ring"`` or ``"ulysses"``; Ulysses folds batch into heads, so
    batch·heads must divide over the positions.  Batch is not sharded."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown strategy {strategy!r}")
    comm = sanitize_comm(comm)
    comm.only_local("sequence.sequence_parallel_attention")
    n = comm.size
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"sequence_parallel_attention takes (batch, heads, seq, head_dim), got {q.ndim}-D")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[2] % n:
            raise ValueError(f"{name}'s sequence of {t.shape[2]} does not divide over {n} positions")
    qs, ks, vs = (list(t.split(t.shape[2] // n, dim=2)) for t in (q, k, v))
    if strategy == "ring":
        out = ring_attention(qs, ks, vs, causal=causal)
    else:
        b, h = q.shape[:2]

        def fold(parts):
            return [p.reshape(b * h, p.shape[2], p.shape[3]) for p in parts]

        out = ulysses_attention(fold(qs), fold(ks), fold(vs), causal=causal)
        out = [o.reshape(b, h, o.shape[1], o.shape[2]) for o in out]
    return torch.cat(out, dim=2)
