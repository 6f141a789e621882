"""Sparse manipulations (counterpart of heat_tpu/sparse/manipulations.py):
``todense``.

Each position scatters its triple into its own dense row block, so a
row-split matrix gives a row-split DNDarray and the global dense matrix
never exists in one place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sanitation, telemetry
from ..core.dndarray import DNDarray
from ._operations import _expand_rows
from .dcsr_matrix import DCSR_matrix

__all__ = ["todense", "to_dense"]


def _scatter_block(data: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor, ncols: int) -> torch.Tensor:
    rows = _expand_rows(ptr, data.numel())
    block = torch.zeros((ptr.numel() - 1, ncols), dtype=data.dtype, device=data.device)
    return block.index_put_((rows, idx.to(torch.int64)), data, accumulate=True)


def todense(sparse_matrix: DCSR_matrix, order: str = "C", out: Optional[DNDarray] = None) -> DNDarray:
    """The matrix as a dense DNDarray with its split."""
    A = sparse_matrix
    ncols = A.shape[1]
    # every densification is an event: a sparse end-to-end path (the knn
    # Spectral fit) shows none of them
    telemetry.record_event("sparse_densify", shape=tuple(A.shape), nnz=A.nnz, split=A.split)
    blocks = [_scatter_block(d, i, p, ncols) for d, i, p in A._shards]
    if not A.is_distributed():
        blocks = blocks * A.comm.size
    result = DNDarray(blocks, A.shape, A.dtype, A.split, A.device, A.comm)
    if out is not None:
        return sanitation.sanitize_out(out, result)
    return result


to_dense = todense
