"""Pairwise distance matrices (counterpart of heat_tpu/spatial/distance.py):
``cdist``.

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

Dispatch mirrors ``_pallas_eligible``: when the promoted dtype is float32
each block goes through K1 (:mod:`heat_tpu_torch.ops.cdist`), which on the
card launches the CUDA kernel.  Other dtypes take the torch expansion below,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sanitation, types
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives

__all__ = ["cdist"]


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
    """Quadratic expansion |a|² + |b|² − 2a·b for non-f32 dtypes (the JAX
    package's ``_sq_euclidean``): 16-bit input accumulates in f32, f64 keeps
    f64.  Values within rounding noise of 0 are set to exactly 0."""
    if xa.element_size() < 4:
        xa, ya = xa.to(torch.float32), ya.to(torch.float32)
    x2 = torch.sum(xa * xa, dim=1)[:, None]
    y2 = torch.sum(ya * ya, dim=1)[None, :]
    d2 = x2 + y2 - 2.0 * (xa @ ya.T)
    eps = torch.finfo(d2.dtype).eps
    d2 = torch.where(d2 <= 4.0 * eps * (x2 + y2), torch.zeros((), dtype=d2.dtype, device=d2.device), d2)
    return torch.clamp(d2, min=0.0)


def _block(xa: torch.Tensor, ya: torch.Tensor, promoted, sqrt: bool) -> torch.Tensor:
    """Distances of one block of rows of x to one block of rows of y."""
    tt = promoted.torch_type()
    xa, ya = xa.to(tt).contiguous(), ya.to(tt).contiguous()
    if promoted is types.float32:
        return _k1.cdist(xa, ya, sqrt=sqrt)
    d2 = _sq_euclidean(xa, ya)
    return torch.sqrt(d2) if sqrt else d2


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
