"""Pairwise distance matrices (counterpart of heat_tpu/spatial/distance.py):
``cdist``, the Gaussian similarity ``rbf`` and the L1 ``manhattan``.

Layouts, by the operands' splits:

* x row-split, y replicated (the KMeans shape; ``_pallas_rowsplit_cdist`` in
  the JAX package): each position computes its rows against all of y;
* x replicated, y row-split: each position computes all rows against its
  block of y, which is the result's column block (result split 1);
* both replicated: one computation, replicated;
* both row-split: y is all-gathered and each position computes its rows
  against it.  The JAX package rotates y's blocks around a ring instead
  (``_build_ring_cdist``); the values are the same, and the ring is a later
  slice.  A feature-split operand is gathered first.

Dispatch: when the promoted dtype is float32 each block goes through K1
(:mod:`heat_tpu_torch.ops.cdist`), which on the card launches the CUDA
kernel, as ``_pallas_eligible`` sends it in the JAX package.  16-bit blocks
go through K1 too, as they are (K1 widens its tiles itself), followed by
the noise floor of the JAX package's ``_sq_euclidean``: no f32 copy of a
16-bit operand is made (at 1e8 x 64 bf16 it would be 25.6 GB).  float64
takes the torch expansion below, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sanitation, types
from ..core._operations import _local_op
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives

__all__ = ["cdist", "cdist_quantized", "manhattan", "rbf"]


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


def _block(xa: torch.Tensor, ya: torch.Tensor, promoted, sqrt: bool) -> torch.Tensor:
    """Distances of one block of rows of x to one block of rows of y."""
    if promoted is types.float64:
        d2 = _sq_euclidean(xa.to(torch.float64), ya.to(torch.float64))
        return torch.sqrt(d2) if sqrt else d2
    if promoted is types.float32:
        # a 16-bit x stays as it is against f32 y: K1 widens its tiles
        if xa.dtype not in (torch.bfloat16, torch.float16):
            xa = xa.to(torch.float32)
        return _k1.cdist(xa.contiguous(), ya.to(torch.float32).contiguous(), sqrt=sqrt)
    tt = promoted.torch_type()
    xa, ya = xa.to(tt).contiguous(), ya.to(tt).contiguous()
    d2 = _noise_floor_(_k1.cdist(xa, ya, sqrt=False), xa, ya)
    return d2.sqrt_() if sqrt else d2


def _whole(a: DNDarray) -> torch.Tensor:
    """The global tensor of ``a``, all-gathered when it is split."""
    if a.split is None:
        return a.shards[0]
    return collectives.all_gather(a.shards, dim=a.split)[0]


def cdist(x: DNDarray, y: Optional[DNDarray] = None, quadratic_expansion: bool = False, sqrt: bool = True) -> DNDarray:
    """Euclidean distance matrix of the rows of x to the rows of y (of x to
    itself when y is None).  ``quadratic_expansion`` is accepted for parity:
    the expansion is always used.  ``sqrt=False`` gives squared distances."""
    x, y, promoted = _check(x, y)
    comm = x.comm
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
    comp = torch.promote_types(x.dtype.torch_type(), torch.float32)
    mb = qy.shape[0] // n_dev
    shards = []
    for me, xs in enumerate(x.shards):
        xs = xs.to(comp).contiguous()
        out = xs.new_empty((xs.shape[0], n_dev * mb))
        scale = qy.scale.to(xs.device)[None, :]
        for t in range(n_dev):
            # after t backward shifts this position holds the block that
            # started on position (me - t) mod n: its column offset
            src = (me - t) % n_dev
            ys = (qy.qshards[src].to(xs.device).to(torch.float32) * scale).to(comp)
            out[:, src * mb : (src + 1) * mb] = _block(xs, ys, types.canonical_heat_type(comp), sqrt)
        shards.append(out)
    return DNDarray(shards, (x.shape[0], qy.shape[0]), types.canonical_heat_type(shards[0].dtype), 0, x.device, comm)


def rbf(x: DNDarray, y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian (RBF) similarity exp(−d²/2σ²) of the rows of x to the rows
    of y, over the squared distances of :func:`cdist` (K1 for float32, in
    every layout).  ``quadratic_expansion`` is accepted for parity."""
    return _local_op(lambda d2: torch.exp(-d2 / (2.0 * sigma * sigma)), cdist(x, y, sqrt=False))


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
