"""Memory layout helpers (counterpart of heat_tpu/core/memory.py):
``copy`` and ``sanitize_memory_layout``."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x: DNDarray) -> DNDarray:
    """A copy of the array: each shard copied where it lies, split, device
    and mesh kept (a replicated array copies its one tensor once)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, got {type(x)}")
    shards = x.shards
    if x.split is None:
        shards = [shards[0].clone()] * x.comm.size
    else:
        shards = [s.clone() for s in shards]
    return DNDarray(shards, x.shape, x.dtype, x.split, x.device, x.comm)


def sanitize_memory_layout(x, order: str = "C"):
    """Check ``order``; shards are row-major (C order) throughout, so ``x``
    comes back as it is."""
    if order not in ("C", "F"):
        raise ValueError(f"order must be 'C' or 'F', got {order!r}")
    return x
