"""Pairwise distance matrices (counterpart of heat_tpu/spatial/distance.py):
``cdist``, the Gaussian similarity ``rbf`` and the L1 ``manhattan``.

Layouts, by the operands' splits:

* x row-split, y replicated (the KMeans shape; ``_pallas_rowsplit_cdist`` in
  the JAX package): each position computes its rows against all of y;
* x replicated, y row-split: each position computes all rows against its
  block of y, which is the result's column block (result split 1);
* both replicated: one computation, replicated;
* both row-split, rows dividing evenly over several positions: the ring of
  the JAX package (``_build_ring_cdist``, ``_ring_cdist``): each position
  keeps its block of x while y's blocks pass around the ring
  (``parallel.overlap.ring_sweep``), every step's block through K1, so K1
  launches S times a position a call and no gathered copy of y exists.  An
  eligible f32 y may travel on a quantized wire (``core/wire.py``; tuned
  only where the positions span devices, forced anywhere), the program
  :func:`cdist_quantized` runs for a corpus quantized already;
* both row-split otherwise: y is all-gathered and each position computes
  its rows against it.  A feature-split operand is gathered first.

Dispatch: when the promoted dtype is float32 each block goes through K1
(:mod:`heat_tpu_torch.ops.cdist`), which on the card launches the CUDA
kernel, as ``_pallas_eligible`` sends it in the JAX package.  16-bit blocks
go through K1 too, as they are (K1 widens its tiles itself), followed by
the noise floor of the JAX package's ``_sq_euclidean``: no f32 copy of a
16-bit operand is made (at 1e8 x 64 bf16 it would be 25.6 GB).  float64
takes the torch expansion below, as the JAX package leaves it to XLA.

Under the fusion engine (:mod:`~heat_tpu_torch.core.fusion`) ``cdist``
defers as one ``euclid_cdist`` node whose body is the dispatch above (K1 on
the card), in every layout but the ring one, which stays eager as
heat_tpu's does (its ``cdist`` defers only where neither the Pallas layout
nor ``_ring_eligible`` holds); ``rbf`` extends that node with its ``neg``,
``div`` and ``exp`` nodes, so KMeans' labels and inertia, or a kernel
matrix and its consumers, run as one program with one K1 launch a position.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import _operations, autotune, exponential, fusion, sanitation, types
from ..core import wire as _wire
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives

__all__ = ["cdist", "cdist_quantized", "manhattan", "rbf"]


def _stream_topk_merge(q: torch.Tensor, slab: torch.Tensor, valid: int, base: int, best_d: torch.Tensor,
                       best_i: torch.Tensor, k: int):
    """The running k-nearest merge against one streamed corpus slab
    (heat_tpu :93): K1's squared distances of the queries to the slab (f32;
    no sqrt, which keeps the order), rows at or past ``valid`` masked to
    +inf, global corpus indices from ``base``, then the k smallest of the
    carried best and the slab's, ``lax.top_k``'s stable order: the carry
    (earlier, lower indices) precedes the slab, so a tie keeps the lower
    corpus index, as the in-memory predict does."""
    from ..parallel.sort import topk_order

    rows = slab.shape[0]
    xq = q if q.dtype in (torch.bfloat16, torch.float16) else q.to(torch.float32)
    d2 = _k1.cdist(xq.contiguous(), slab.to(torch.float32).contiguous(), sqrt=False)
    if valid < rows:
        d2[:, valid:] = float("inf")
    ids = (base + torch.arange(rows, dtype=torch.int64, device=d2.device))[None, :].expand(q.shape[0], rows)
    cat_d = torch.cat([best_d, d2], dim=1)
    cat_i = torch.cat([best_i, ids], dim=1)
    sel = topk_order(cat_d, k, largest=False)
    return cat_d.gather(1, sel), cat_i.gather(1, sel)


def _check(x: DNDarray, y: Optional[DNDarray]):
    sanitation.sanitize_in(x)
    if y is None:
        y = x
    sanitation.sanitize_in(y)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError("cdist requires 2-D inputs")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dimensions differ: {x.shape[1]} vs {y.shape[1]}")
    promoted = types.promote_types(x.dtype, y.dtype)
    if not issubclass(promoted, types.floating):
        promoted = types.float32
    return x, y, promoted


def _sq_euclidean(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Quadratic expansion |a|² + |b|² − 2a·b in float64 (the JAX package's
    ``_sq_euclidean``).  Values within rounding noise of 0 are set to
    exactly 0."""
    x2 = torch.sum(xa * xa, dim=1)[:, None]
    y2 = torch.sum(ya * ya, dim=1)[None, :]
    d2 = x2 + y2 - 2.0 * (xa @ ya.T)
    eps = torch.finfo(d2.dtype).eps
    d2 = torch.where(d2 <= 4.0 * eps * (x2 + y2), torch.zeros((), dtype=d2.dtype, device=d2.device), d2)
    return torch.clamp(d2, min=0.0)


# rows of x widened at a time for the noise floor's norms (64 MB of f32 at
# d = 64): the floor reads x a second time, never as a whole f32 copy
_FLOOR_ROWS = 1 << 18


def _row_norms(t: torch.Tensor) -> torch.Tensor:
    """|row|² of a 16-bit block in f32, widening _FLOOR_ROWS rows at a time."""
    return torch.cat([
        torch.sum(torch.square(t[lo : lo + _FLOOR_ROWS].to(torch.float32)), dim=1)
        for lo in range(0, max(t.shape[0], 1), _FLOOR_ROWS)
    ])


def _noise_floor_(d2: torch.Tensor, xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_sq_euclidean`` floor on K1's f32 squared
    distances of 16-bit rows, in place: d2 <= 4·eps·(|a|² + |b|²) → 0
    (for a ≈ b the expansion cancels to rounding noise of that size)."""
    eps4 = 4.0 * torch.finfo(torch.float32).eps
    x2, y2 = _row_norms(xa)[:, None], _row_norms(ya)[None, :]
    for lo in range(0, xa.shape[0], _FLOOR_ROWS):
        part = d2[lo : lo + _FLOOR_ROWS]
        part.masked_fill_(part <= eps4 * (x2[lo : lo + _FLOOR_ROWS] + y2), 0.0)
    return d2


def _k1_into(xa: torch.Tensor, ya: torch.Tensor, sqrt: bool, out: Optional[torch.Tensor]) -> torch.Tensor:
    """K1's distances, into ``out`` when it is given."""
    if out is None:
        return _k1.cdist(xa, ya, sqrt=sqrt)
    return _k1.cdist(xa, ya, sqrt=sqrt, out=out)


def _block(xa: torch.Tensor, ya: torch.Tensor, promoted, sqrt: bool, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distances of one block of rows of x to one block of rows of y,
    written into ``out`` (a column slice of the result) when it is given."""
    if xa.device.type == "meta":
        # the fusion engine's metadata probe: the shape and type, no launch
        return xa.new_empty((xa.shape[0], ya.shape[0]),
                            dtype=torch.float64 if promoted is types.float64 else torch.float32)
    if promoted is types.float64:
        d2 = _sq_euclidean(xa.to(torch.float64), ya.to(torch.float64))
        d = torch.sqrt(d2) if sqrt else d2
        return d if out is None else out.copy_(d)
    if promoted is types.float32:
        # a 16-bit x stays as it is against f32 y: K1 widens its tiles
        if xa.dtype not in (torch.bfloat16, torch.float16):
            xa = xa.to(torch.float32)
        return _k1_into(xa.contiguous(), ya.to(torch.float32).contiguous(), sqrt, out)
    tt = promoted.torch_type()
    xa, ya = xa.to(tt).contiguous(), ya.to(tt).contiguous()
    d2 = _noise_floor_(_k1_into(xa, ya, False, out), xa, ya)
    return d2.sqrt_() if sqrt else d2


def _whole(a: DNDarray) -> torch.Tensor:
    """The global tensor of ``a``, all-gathered when it is split."""
    if a.split is None:
        return a.shards[0]
    return collectives.all_gather(a.shards, dim=a.split)[0]


def _ring_eligible(x: DNDarray, y: DNDarray) -> bool:
    """heat_tpu's ring layout (``_ring_eligible``), which stays eager."""
    n = x.comm.size
    return x.split == 0 and y.split == 0 and n > 1 and x.shape[0] % n == 0 and y.shape[0] % n == 0


def _ring_blocks(x_shards, moving, n_cols: int, promoted, sqrt: bool, block_of) -> list:
    """The ring dataflow of heat_tpu's ``_build_ring_cdist``: each position
    keeps its x block while the ``moving`` blocks (one a position, ``mb``
    rows each) pass up the ring; at step t position ``me`` holds the block
    that started on position (me - t) mod S, whose distances K1 writes
    straight into that block's columns (no temporary, no copy).  ``block_of(item)`` gives the rows of y of a moving
    item (a dequantization for a quantized corpus)."""
    from ..parallel.overlap import ring_sweep

    S = len(x_shards)
    mb = n_cols // S
    tt = torch.float64 if promoted is types.float64 else torch.float32

    def step(t, me, item, out):
        src = (me - t) % S
        _block(x_shards[me], block_of(item), promoted, sqrt, out=out[:, src * mb : (src + 1) * mb])
        return out

    state = [xs.new_empty((xs.shape[0], n_cols), dtype=tt) for xs in x_shards]
    return ring_sweep(S, list(moving), state, step)


def _ring_cdist(x: DNDarray, y: DNDarray, promoted, sqrt: bool, exact: bool = False) -> DNDarray:
    """The both-row-split ring (heat_tpu :323), every block through K1.  An
    eligible f32 corpus may rotate absmax-quantized with global per-feature
    scales (the wire plane's ``cdist`` site), measured against the f32 ring
    while the table explores; positions on one device take the f32 ring
    unless a wire mode is forced (``wire.choose``'s ``links``)."""
    comm = x.comm
    n_dev = comm.size
    mb = y.shape[0] // n_dev
    d_feat = y.shape[1]
    tt = promoted.torch_type()
    moved = mb * d_feat * (n_dev - 1) * max(tt.itemsize, 1)

    def run_f32():
        return _ring_blocks(x.shards, y.shards, y.shape[0], promoted, sqrt, lambda ys: ys)

    def run_q(wm):
        # per-feature scales over the WHOLE corpus: each position's absmax,
        # then their maximum, so every block dequantizes with one table
        amax = collectives.pmax([torch.amax(ys.to(torch.float32).abs(), dim=0) for ys in y.shards])[0]
        scale = _wire.scale_of(amax, wm)
        q = [_wire.to_grid(ys, scale.to(ys.device)[None, :], wm) for ys in y.shards]
        return _ring_q(x.shards, q, scale, y.shape[0], promoted, sqrt)

    wire_arm, wire_d = "wire_f32", None
    dt = autotune.dtype_name(tt)
    if _wire.eligible(tt, moved, exact=exact):
        wire_arm, wire_d = _wire.choose("cdist", (tuple(x.shape), tuple(y.shape), n_dev, dt),
                                        desc=f"ring cdist {tuple(x.shape)}x{tuple(y.shape)} S={n_dev}",
                                        links=len({t.device for t in (*x.shards, *y.shards)}) > 1)
    if wire_d is not None and wire_d.explore:
        shards = _wire.explore(wire_d, lambda wm: run_q(wm) if wm else run_f32())
    elif wire_arm != "wire_f32":
        wm = wire_arm[len("wire_"):]
        _wire.account("cdist", wire_arm, moved, _wire.payload_nbytes(mb * d_feat * (n_dev - 1), d_feat, wm))
        shards = run_q(wm)
    else:
        shards = run_f32()
    return DNDarray(shards, (x.shape[0], y.shape[0]), types.canonical_heat_type(shards[0].dtype), 0, x.device, comm)


def _ring_q(x_shards, q_shards, scale: torch.Tensor, n_cols: int, promoted, sqrt: bool) -> list:
    """The quantized-corpus ring (heat_tpu :245): the int8/fp8 blocks move,
    each dequantized with the global per-feature ``scale`` just before K1."""
    comp = promoted.torch_type()
    dev = x_shards[0].device
    sc = scale.to(dev)[None, :]
    xs = [t.to(comp).contiguous() for t in x_shards]
    return _ring_blocks(xs, q_shards, n_cols, promoted, sqrt,
                        lambda q: (q.to(dev).to(torch.float32) * sc).to(comp))


def cdist(x: DNDarray, y: Optional[DNDarray] = None, quadratic_expansion: bool = False, sqrt: bool = True) -> DNDarray:
    """Euclidean distance matrix of the rows of x to the rows of y (of x to
    itself when y is None).  ``quadratic_expansion`` is accepted for parity:
    the expansion is always used.  ``sqrt=False`` gives squared distances.
    Under fusion one ``euclid_cdist`` node, but in the ring layout."""
    x, y, _ = _check(x, y)
    if fusion.enabled() and not _ring_eligible(x, y):
        return _operations._composite(_euclid, x, y, sqrt=bool(sqrt))
    return _euclid(x, y, sqrt)


def _euclid(x: DNDarray, y: DNDarray, sqrt: bool) -> DNDarray:
    """The eager cdist: one block per position (S blocks a position in the
    ring layout), through K1 for f32."""
    x, y, promoted = _check(x, y)
    comm = x.comm
    if _ring_eligible(x, y):
        return _ring_cdist(x, y, promoted, sqrt)
    if x.split == 0:
        ya = _whole(y)
        shards, split = [_block(xs, ya, promoted, sqrt) for xs in x.shards], 0
    elif y.split == 0:
        xa = _whole(x)
        shards, split = [_block(xa, ys, promoted, sqrt) for ys in y.shards], 1
    else:
        out = _block(_whole(x), _whole(y), promoted, sqrt)
        shards, split = [out] * comm.size, None
    return DNDarray(
        shards, (x.shape[0], y.shape[0]), types.canonical_heat_type(shards[0].dtype),
        split, x.device, comm,
    )


def cdist_quantized(x: DNDarray, qy, sqrt: bool = True) -> Optional[DNDarray]:
    """Distances of the rows of ``x`` to a quantized corpus ``qy`` (a
    :class:`~heat_tpu_torch.core.quantize.QuantizedDNDarray` with
    per-feature scales, ``axis=1``) in the quantized ring's dataflow
    (heat_tpu/spatial/distance.py:245, :282): each position keeps its block
    of x while the int8/fp8 blocks of the corpus pass around the ring, and
    each block is dequantized with the global per-feature scales just
    before its distances, which K1 computes (one launch a position and
    block).  The f32 corpus never exists at rest.  ``None`` where the
    ring's layout does not fit (one position, a split other than rows, rows
    that do not divide over the positions): the caller dequantizes and
    takes :func:`cdist`."""
    sanitation.sanitize_in(x)
    if qy.axis != 1:
        raise ValueError(
            "cdist_quantized needs per-feature scales (channel axis 1 of "
            f"the (n, d) corpus), got channel axis {qy.axis}"
        )
    if x.shape[-1] != qy.shape[1]:
        raise ValueError(f"feature dims disagree: {x.shape} vs corpus {qy.shape}")
    comm = x.comm
    n_dev = comm.size
    if not (x.split == 0 and qy.split == 0 and n_dev > 1 and x.shape[0] % n_dev == 0 and qy.shape[0] % n_dev == 0):
        return None
    comp = types.canonical_heat_type(torch.promote_types(x.dtype.torch_type(), torch.float32))
    shards = _ring_q(x.shards, qy.qshards, qy.scale, qy.shape[0], comp, sqrt)
    return DNDarray(shards, (x.shape[0], qy.shape[0]), types.canonical_heat_type(shards[0].dtype), 0, x.device, comm)


def rbf(x: DNDarray, y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian (RBF) similarity exp(−d²/2σ²) of the rows of x to the rows
    of y, over the squared distances of :func:`cdist` (K1 for float32, in
    every layout).  ``quadratic_expansion`` is accepted for parity.  Under
    fusion the ``neg``, ``div`` and ``exp`` extend cdist's node."""
    d2 = cdist(x, y, sqrt=False)
    return exponential.exp(-d2 / (2.0 * sigma * sigma))


# elements of the (rows, m, f) broadcast that one block of :func:`_l1`
# holds (256 MB of f32)
_L1_ELEMENTS = 1 << 26


def _l1(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """(n, m) Manhattan distances of the rows of xa to those of ya (one
    dtype), a block of rows at a time: no (n, m, f) buffer exists."""
    n, f = xa.shape
    m = ya.shape[0]
    acc = torch.float32 if xa.dtype in (torch.bfloat16, torch.float16) else None
    out = torch.empty((n, m), dtype=xa.dtype, device=xa.device)
    step = max(1, _L1_ELEMENTS // max(1, m * f))
    for lo in range(0, n, step):
        diff = xa[lo : lo + step, None, :] - ya[None, :, :]
        out[lo : lo + step] = torch.sum(diff.abs_(), dim=-1, dtype=acc)
    return out


def manhattan(x: DNDarray, y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """L1 distance matrix of the rows of x to the rows of y (of x to itself
    when y is None), in the promoted float type, split as ``cdist``'s:
    rows of a row-split x, columns of a row-split y, else replicated.
    ``expand`` is accepted for parity."""
    x, y, promoted = _check(x, y)
    tt = promoted.torch_type()
    comm = x.comm
    if x.split == 0:
        ya = _whole(y).to(tt)
        shards, split = [_l1(xs.to(tt), ya) for xs in x.shards], 0
    elif y.split == 0:
        xa = _whole(x).to(tt)
        shards, split = [_l1(xa, ys.to(tt)) for ys in y.shards], 1
    else:
        out = _l1(_whole(x).to(tt), _whole(y).to(tt))
        shards, split = [out] * comm.size, None
    return DNDarray(
        shards, (x.shape[0], y.shape[0]), types.canonical_heat_type(shards[0].dtype),
        split, x.device, comm,
    )


fusion.register_op(_euclid, "euclid_cdist", kind="composite")
