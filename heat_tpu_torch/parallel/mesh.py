"""Shard positions of the single controller (counterpart of
heat_tpu/parallel/mesh.py).

One process drives a :class:`MeshComm` of ``size`` shard positions.  A split
array keeps one torch tensor per position; which torch device those tensors
live on is the array's :class:`~heat_tpu_torch.core.devices.Device`.  Shards
follow the JAX package's chunk rule: even ``ceil(n/N)`` chunks with the
trailing shards truncated, possibly to zero rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["Communication", "MeshComm", "get_comm", "use_comm", "sanitize_comm", "world"]


class Communication:
    """Abstract base for communication contexts."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class MeshComm(Communication):
    """``size`` shard positions along the split axis."""

    def __init__(self, size: int = 1):
        size = int(size)
        if size < 1:
            raise ValueError(f"a mesh needs at least one position, got {size}")
        self.__size = size

    @property
    def size(self) -> int:
        """Number of shard positions."""
        return self.__size

    @property
    def rank(self) -> int:
        """Index of this process; always 0 under the single controller."""
        return 0

    def is_distributed(self) -> bool:
        return self.__size > 1

    def __repr__(self) -> str:
        return f"MeshComm(size={self.__size})"

    def chunk(
        self, shape: Tuple[int, ...], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """(offset, local shape, slices) of one position's shard
        (heat_tpu/parallel/mesh.py:121)."""
        if split is None:
            return 0, tuple(shape), tuple(slice(0, end) for end in shape)
        rank = 0 if rank is None else int(rank)
        dims = len(shape)
        split = split % dims if dims else 0
        size = shape[split]
        per = _ceil_div(size, self.__size) if size > 0 else 0
        start = min(rank * per, size)
        end = min((rank + 1) * per, size)
        lshape = list(shape)
        lshape[split] = end - start
        slices = tuple(
            slice(start, end) if i == split else slice(0, shape[i]) for i in range(dims)
        )
        return start, tuple(lshape), slices

    def lshape_map(self, shape: Tuple[int, ...], split: Optional[int]) -> np.ndarray:
        """(size, ndim) matrix of per-position shard shapes
        (heat_tpu/parallel/mesh.py:149)."""
        n = self.__size
        if len(shape) == 0:
            return np.zeros((n, 0), dtype=np.int64)
        out = np.empty((n, len(shape)), dtype=np.int64)
        for r in range(n):
            out[r] = self.chunk(shape, split, rank=r)[1]
        return out


_world_comm: Optional[MeshComm] = None
_default_comm: Optional[MeshComm] = None


def world() -> MeshComm:
    """The all-position context: one position, which on the card is the one
    H100.  Several cards in one mesh are a later slice (ROADMAP item 14)."""
    global _world_comm
    if _world_comm is None:
        _world_comm = MeshComm(1)
    return _world_comm


def get_comm() -> MeshComm:
    """The current default context; starts as :func:`world`."""
    return _default_comm if _default_comm is not None else world()


def use_comm(comm: Optional[MeshComm] = None) -> None:
    """Set the default context (``None`` restores :func:`world`)."""
    global _default_comm
    if comm is not None and not isinstance(comm, MeshComm):
        raise TypeError(f"comm must be a MeshComm, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm: Optional[Communication]) -> MeshComm:
    """Validate-or-default a communication context."""
    if comm is None:
        return get_comm()
    if isinstance(comm, MeshComm):
        return comm
    raise TypeError(f"comm must be None or a MeshComm, got {type(comm)}")
