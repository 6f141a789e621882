"""Distributed CSR matrix (counterpart of heat_tpu/sparse/dcsr_matrix.py).

A row-split matrix holds one CSR triple per mesh position, cut by the chunk
rule of :meth:`MeshComm.chunk` (even ``ceil(n/N)`` row chunks, the trailing
ones truncated, possibly to zero rows): ``data`` (its nonzero values),
``indices`` (their global column ids, int32) and ``indptr`` (int32 row
pointers over its own rows, rebased to 0).  A replicated matrix
(``split=None``), like a matrix on a mesh of one position, holds one triple
for the whole matrix.  The JAX package pads every position's triple to one
common capacity so that the slabs stack into one sharded array; the port
keeps each triple at its own length.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import devices as ht_devices
from ..core import types
from ..core.dndarray import DNDarray
from ..parallel.mesh import MeshComm

__all__ = ["DCSR_matrix"]

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class DCSR_matrix:
    """Distributed compressed-sparse-row matrix.

    Parameters
    ----------
    array : sequence of (data, indices, indptr) or scipy sparse matrix
        One CSR triple of torch tensors per position (one in all when the
        matrix is not distributed), or a scipy matrix, which is cut here.
    gnnz : int
        Global number of stored entries.
    gshape : (int, int)
        Global shape.
    dtype : heat type
        Element type of ``data``.
    split : 0 or None
        Row chunks over the positions, or replicated.
    device : Device
    comm : MeshComm
    """

    def __init__(
        self,
        array,
        gnnz: int,
        gshape: Tuple[int, int],
        dtype,
        split: Optional[int],
        device: ht_devices.Device,
        comm: MeshComm,
        balanced: bool = True,
    ):
        if not isinstance(array, (list, tuple)):
            import scipy.sparse

            if not scipy.sparse.issparse(array):
                raise TypeError(f"array must be a sequence of CSR triples or a scipy sparse matrix, got {type(array)}")
            from .factories import sparse_csr_matrix

            array = sparse_csr_matrix(array.tocsr(), split=split, device=device, comm=comm)._shards
        self.__shards: List[Triple] = [tuple(t) for t in array]
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm
        if len(self.__shards) != self.nshards:
            raise ValueError(f"expected {self.nshards} CSR triples, got {len(self.__shards)}")
        if int(gnnz) != self.nnz:
            raise ValueError(f"gnnz {gnnz} does not match the triples' counts {self.nnz}")
        # derived on first use: the SpMV kernel's repacking of each triple
        self._spmv_panels = None

    @classmethod
    def _from_shards(cls, shards: Sequence[Triple], gshape, dtype, split, device, comm) -> "DCSR_matrix":
        return cls(list(shards), sum(int(s[0].numel()) for s in shards), gshape, dtype, split, device, comm)

    # ---------------------------------------------------------- shard views
    @property
    def _shards(self) -> List[Triple]:
        """The CSR triples, one per position (one when not distributed)."""
        return list(self.__shards)

    @property
    def nshards(self) -> int:
        return self.__comm.size if self.is_distributed() else 1

    @property
    def rows_per_shard(self) -> int:
        """Rows of a full chunk (the chunk rule's ``ceil(n/N)``); the last
        positions' chunks may be shorter."""
        if not self.is_distributed():
            return self.__gshape[0]
        return -(-self.__gshape[0] // self.__comm.size)

    def _row_range(self, rank: int) -> Tuple[int, int]:
        if not self.is_distributed():
            return 0, self.__gshape[0]
        off, lshape, _ = self.__comm.chunk(self.__gshape, 0, rank=rank)
        return off, off + lshape[0]

    def shard_csr(self, rank: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One position's (data, indices, indptr) as numpy arrays; a
        replicated matrix's every position sees the whole matrix."""
        d, i, p = self.__shards[rank if self.is_distributed() else 0]
        return d.cpu().numpy(), i.cpu().numpy(), p.cpu().numpy()

    def trim(self) -> "DCSR_matrix":
        """This matrix.  The JAX package shrinks its slabs' common capacity
        to the largest position's nnz; the port keeps each triple at its
        own length, so there is no slack to shrink."""
        return self

    @property
    def ldata(self) -> torch.Tensor:
        """The calling position's values, on its device (the whole
        matrix's when it is not distributed)."""
        return self.__shards[0][0]

    @property
    def lindices(self) -> torch.Tensor:
        """The calling position's column ids (int32)."""
        return self.__shards[0][1]

    @property
    def lindptr(self) -> torch.Tensor:
        """The calling position's row pointers over its rows (int32)."""
        return self.__shards[0][2]

    # -------------------------------------------------------- global views
    def _gathered(self) -> Triple:
        """The global (data, indices, indptr) on the matrix's device: the
        triples joined, each position's row pointers offset by the entries
        before it."""
        if self.nshards == 1:
            return self.__shards[0]
        ptrs, displ = [], 0
        for d, _, p in self.__shards:
            ptrs.append(p[:-1] + displ)
            displ += int(d.numel())
        last = self.__shards[-1][2]
        ptrs.append(torch.full((1,), displ, dtype=last.dtype, device=last.device))
        return (
            torch.cat([s[0] for s in self.__shards]),
            torch.cat([s[1] for s in self.__shards]),
            torch.cat(ptrs),
        )

    def _assemble(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The global (data, indices, indptr) on the host: an export path
        (``to_scipy``, tests), not the compute path."""
        return tuple(t.cpu().numpy() for t in self._gathered())

    @property
    def data(self) -> torch.Tensor:
        """The global values, gathered on the matrix's device."""
        return self._gathered()[0]

    gdata = data

    @property
    def indices(self) -> torch.Tensor:
        """The global column ids (int32)."""
        return self._gathered()[1]

    gindices = indices

    @property
    def indptr(self) -> torch.Tensor:
        """The global row pointers (int32)."""
        return self._gathered()[2]

    gindptr = indptr

    @property
    def larray(self) -> torch.Tensor:
        """The gathered matrix as a ``torch.sparse_csr_tensor`` on the
        matrix's device (the JAX package gives a ``jax.experimental.sparse``
        BCSR); an export view, not the compute path."""
        d, i, p = self._gathered()
        return torch.sparse_csr_tensor(p, i, d, size=self.__gshape)

    @property
    def global_indptr(self) -> DNDarray:
        """The global row pointers as a replicated int32 DNDarray."""
        ptr = self._gathered()[2]
        return DNDarray([ptr] * self.__comm.size, tuple(ptr.shape), types.int32, None, self.__device, self.__comm)

    def to_scipy(self):
        """The matrix as a ``scipy.sparse.csr_matrix`` (a host gather)."""
        import scipy.sparse

        d, i, p = self._assemble()
        return scipy.sparse.csr_matrix((d, i, p), shape=self.__gshape)

    # ------------------------------------------------------------- metadata
    @property
    def comm(self) -> MeshComm:
        return self.__comm

    @property
    def device(self) -> ht_devices.Device:
        return self.__device

    @property
    def ndim(self) -> int:
        return 2

    @property
    def lnnz_all(self) -> Tuple[int, ...]:
        """Stored entries of each position's triple."""
        return tuple(int(s[0].numel()) for s in self.__shards)

    @property
    def nnz(self) -> int:
        return sum(self.lnnz_all)

    gnnz = nnz

    @property
    def lnnz(self) -> int:
        return self.lnnz_all[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    gshape = shape

    @property
    def lshape(self) -> Tuple[int, int]:
        """The calling position's rows by every column when split, else the
        global shape."""
        return self.__comm.chunk(self.__gshape, 0, rank=self.__comm.rank)[1] if self.__split == 0 else self.__gshape

    @property
    def balanced(self) -> bool:
        """Always: the chunk rule's layout is the balanced one."""
        return True

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    def is_distributed(self) -> bool:
        return self.__split == 0 and self.__comm.size > 1

    def counts_displs_nnz(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-position nnz counts and displacements."""
        counts = self.lnnz_all
        displs = tuple(int(x) for x in np.concatenate(([0], np.cumsum(counts)[:-1])))
        return counts, displs

    # ------------------------------------------------------------------ ops
    def astype(self, dtype, copy: bool = True) -> "DCSR_matrix":
        """Cast the values; ``copy=False`` casts in place of this matrix."""
        dtype = types.canonical_heat_type(dtype)
        tt = dtype.torch_type()
        shards = [(d.to(tt), i, p) for d, i, p in self.__shards]
        if not copy:
            self.__shards = shards
            self.__dtype = dtype
            self._spmv_panels = None  # the repacking holds the old values
            return self
        return DCSR_matrix._from_shards(shards, self.__gshape, dtype, self.__split, self.__device, self.__comm)

    def resplit(self, split: Optional[int]) -> "DCSR_matrix":
        """Re-chunk through a host rebuild, as the JAX package does."""
        if split == self.__split:
            return self
        from .factories import sparse_csr_matrix

        return sparse_csr_matrix(self.to_scipy(), split=split, device=self.__device, comm=self.__comm)

    def todense(self, order: str = "C", out: Optional[DNDarray] = None) -> DNDarray:
        from . import manipulations

        return manipulations.todense(self, order=order, out=out)

    def __matmul__(self, other):
        from .matmul import matmul

        return matmul(self, other)

    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __repr__(self) -> str:
        return (
            f"DCSR_matrix(nnz={self.nnz}, shape={self.__gshape}, "
            f"dtype=ht.{self.__dtype.__name__}, split={self.__split})"
        )
