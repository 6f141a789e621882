"""Index-returning operations (counterpart of heat_tpu/core/indexing.py):
``nonzero`` and ``where``."""

from __future__ import annotations

import torch

from . import sanitation, types
from .dndarray import DNDarray, _wrap

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """Indices of the nonzero elements (heat_tpu/core/indexing.py:14): an
    (nnz, ndim) int64 array, (nnz,) for a 1-D input, replicated, since nnz
    depends on the data.  Each position's indices are found in its own
    shard and offset by its chunk's start.  A 0-d array raises, as in
    numpy and the JAX package."""
    sanitation.sanitize_in(x)
    if x.ndim == 0:
        raise ValueError("Calling nonzero on 0d arrays is not allowed. Use atleast_1d(scalar).nonzero() instead.")
    if x.split is None or x.comm.size == 1:
        idx = torch.nonzero(x.larray)
    else:
        parts = []
        for r, s in enumerate(x.shards):
            off = x.comm.chunk(x.shape, x.split, rank=r)[0]
            loc = torch.nonzero(s)
            loc[:, x.split] += off
            parts.append(loc)
        idx = torch.cat(parts)
        if x.split != 0:
            # row-major order over the global array
            order = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
            for d, n in enumerate(x.shape):
                order = order * n + idx[:, d]
            idx = idx[torch.argsort(order)]
    if x.ndim == 1:
        idx = idx[:, 0]
    return DNDarray([idx] * x.comm.size, tuple(idx.shape), types.int64, None, x.device, x.comm)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y``; with neither given,
    :func:`nonzero` (heat_tpu/core/indexing.py:27).  The result keeps
    ``cond``'s split; operands of ``cond``'s shape and split are taken shard
    by shard, anything else meets the gathered condition."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    sanitation.sanitize_in(cond)

    def aligned(v):
        return not isinstance(v, DNDarray) or (v.shape == cond.shape and v.split == cond.split)

    dev = cond.shards[0].device
    if cond.split is not None and aligned(x) and aligned(y) and not (
        isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor)
    ):
        def part(v, r):
            return v.shards[r] if isinstance(v, DNDarray) else v

        shards = [torch.where(c.to(torch.bool), part(x, r), part(y, r)) for r, c in enumerate(cond.shards)]
        return DNDarray(shards, cond.shape, types.canonical_heat_type(shards[0].dtype), cond.split, cond.device, cond.comm)

    def whole(v):
        if isinstance(v, DNDarray):
            return v.larray
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    result = torch.where(cond.larray.to(torch.bool), whole(x), whole(y))
    split = cond.split if result.ndim == cond.ndim else None
    return _wrap(result, split, cond.device, cond.comm)


DNDarray.nonzero = lambda self: nonzero(self)
