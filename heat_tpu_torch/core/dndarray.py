"""The DNDarray: a global n-dimensional array split over mesh positions
(counterpart of heat_tpu/core/dndarray.py).

Where the JAX package holds one global ``jax.Array`` whose sharding places
the split dimension, here the array holds the global shape, dtype and split
plus one torch tensor per mesh position, cut by the chunk rule of
:meth:`MeshComm.chunk`.  A replicated array (``split=None``) holds the same
tensor at every position.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from .devices import Device
from .stride_tricks import sanitize_axis
from ..parallel.mesh import MeshComm

__all__ = ["DNDarray"]


def _shard(tensor: torch.Tensor, split: Optional[int], comm: MeshComm) -> List[torch.Tensor]:
    """Cut a global tensor into one shard per position (views, no copy)."""
    if split is None or tensor.ndim == 0:
        return [tensor] * comm.size
    out = []
    for r in range(comm.size):
        off, lshape, _ = comm.chunk(tuple(tensor.shape), split, rank=r)
        out.append(tensor.narrow(split, off, lshape[split]))
    return out


def _wrap(tensor: torch.Tensor, split: Optional[int], device: Device, comm: MeshComm) -> "DNDarray":
    """A DNDarray over a global tensor, cut for ``split``."""
    split = sanitize_axis(tuple(tensor.shape), split) if tensor.ndim else None
    return DNDarray(
        _shard(tensor, split, comm), tuple(tensor.shape),
        types.canonical_heat_type(tensor.dtype), split, device, comm,
    )


class DNDarray:
    """Distributed n-dimensional array over the positions of a MeshComm.

    Parameters
    ----------
    shards : sequence of torch.Tensor
        One tensor per mesh position, in position order.
    gshape : tuple of int
        Global shape.
    dtype : heat type
        Element type.
    split : int or None
        The dimension cut over the positions; ``None`` = replicated.
    device : Device
        Backend the shards live on.
    comm : MeshComm
        The positions.
    """

    def __init__(
        self,
        shards: Sequence[torch.Tensor],
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: MeshComm,
    ):
        if len(shards) != comm.size:
            raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
        self.__shards = list(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------ properties
    @property
    def shards(self) -> List[torch.Tensor]:
        """The per-position torch tensors, in position order."""
        return list(self.__shards)

    @property
    def larray(self) -> torch.Tensor:
        """The global tensor at its logical shape.  For a split array this
        concatenates the shards (a gather); per-position work reads
        :attr:`shards` instead."""
        if self.__split is None or self.__comm.size == 1:
            return self.__shards[0]
        return torch.cat(self.__shards, dim=self.__split)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    gshape = shape

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of the first position's shard."""
        return tuple(self.__shards[0].shape)

    @property
    def lshape_map(self) -> np.ndarray:
        """(positions, ndim) matrix of shard shapes."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> MeshComm:
        return self.__comm

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.size > 1

    def __repr__(self) -> str:
        return (
            f"DNDarray(shape={self.__gshape}, dtype={self.__dtype.__name__}, "
            f"split={self.__split}, device={self.__device}, comm={self.__comm})"
        )

    # -------------------------------------------------------------- shards
    def lshards(self) -> List[np.ndarray]:
        """Per-position shard data as numpy arrays, in position order
        (heat_tpu/core/dndarray.py:333); a replicated array gives one."""
        if self.__split is None:
            return [self.numpy()]
        return [s.detach().cpu().numpy() for s in self.__shards]

    # ------------------------------------------------------------ conversion
    def numpy(self) -> np.ndarray:
        """Gather to a host numpy array."""
        return self.larray.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype``; ``copy=False`` casts in place of this array."""
        dtype = types.canonical_heat_type(dtype)
        tt = dtype.torch_type()
        if self.__split is None:
            shards = [self.__shards[0].to(tt, copy=copy)] * self.__comm.size
        else:
            shards = [s.to(tt, copy=copy) for s in self.__shards]
        if not copy:
            self.__shards = shards
            self.__dtype = dtype
            return self
        return DNDarray(shards, self.__gshape, dtype, self.__split, self.__device, self.__comm)

    def item(self):
        if self.size != 1:
            raise ValueError("only one-element arrays can be converted to Python scalars")
        return self.larray.reshape(()).item()

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __bool__(self) -> bool:
        return bool(self.item())

    # ----------------------------------------------------------- distribution
    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """In-place re-partition to a new split axis
        (heat_tpu/core/dndarray.py:450): gather, then cut anew."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        self.__shards = _shard(self.larray, axis, self.__comm)
        self.__split = axis
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy of this array split along ``axis``."""
        out = DNDarray(
            self.__shards, self.__gshape, self.__dtype, self.__split, self.__device, self.__comm
        )
        return out.resplit_(axis)
