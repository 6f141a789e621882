"""k-NN graph construction (counterpart of heat_tpu/sparse/knn.py):
dense points in, sparse affinity out.

The pairwise distances are computed in row tiles of 2048 on the points'
device, so at most a (2048, n) block of them exists at a time; each tile's
k nearest neighbours are taken there, and only the k·n surviving edges go
to the host, where scipy assembles the CSR as the JAX package does.

Graph shape (what ``graph.laplacian_sparse`` relies on):

* every vertex carries an explicit zero diagonal entry, so the Laplacian
  is a value transform over the existing entries;
* ``symmetrize=True`` (default) keeps ``W = max(W, Wᵀ)``, an undirected
  graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import telemetry
from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix
from .factories import sparse_csr_matrix

__all__ = ["knn_graph"]

# rows of the distance matrix per tile: a (2048, n) f32 block at a time
_TILE_ROWS = 2048


def _knn_tile(tile: torch.Tensor, pts: torch.Tensor, pts_sq: torch.Tensor, off: int, k: int):
    """Squared distances of one row tile to every point, the tile's own
    points excluded, and the k smallest per row (ascending), with their
    columns.  The expansion |a|² + |b|² − 2a·b is formed in place in one
    (t, n) buffer; the product is a plain ``torch.addmm``, as the JAX
    package leaves it to XLA."""
    t = tile.shape[0]
    d2 = torch.addmm(pts_sq[None, :], tile, pts.T, alpha=-2.0)
    d2.add_(torch.sum(tile * tile, dim=1)[:, None]).clamp_min_(0.0)
    rows = torch.arange(t, device=tile.device)
    d2[rows, rows + off] = float("inf")
    vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return vals, idx


def knn_graph(
    x,
    k: int,
    *,
    weights: str = "rbf",
    sigma: float = 1.0,
    symmetrize: bool = True,
    bucket_cap: bool = False,
    split: Optional[int] = 0,
    device=None,
    comm=None,
) -> DCSR_matrix:
    """The k-nearest-neighbour affinity graph of the rows of ``x`` (n, d)
    as a DCSR matrix, row-split by default.

    ``weights`` is ``"rbf"`` (``exp(-d²/2σ²)``), ``"connectivity"`` (1) or
    ``"distance"`` (d).  ``k`` is clamped to n − 1.  ``symmetrize=False``
    keeps the directed graph, exactly k edges per row.  ``bucket_cap`` is
    accepted for the JAX package's signature (see
    :func:`~heat_tpu_torch.sparse.factories.sparse_csr_matrix`)."""
    if weights not in ("rbf", "connectivity", "distance"):
        raise ValueError(f'weights must be "rbf", "connectivity" or "distance", got {weights!r}')
    if isinstance(x, DNDarray):
        xv = x.larray
        device = device if device is not None else x.device
        comm = comm if comm is not None else x.comm
    else:
        xv = torch.as_tensor(np.asarray(x))
    if xv.ndim != 2:
        raise ValueError(f"x needs to be 2-D, but was {xv.ndim}-D")
    xv = xv.to(torch.float32).contiguous()
    n = int(xv.shape[0])
    kk = max(0, min(int(k), n - 1))

    import scipy.sparse

    if kk > 0:
        pts_sq = torch.sum(xv * xv, dim=1)
        d2s, idxs = [], []
        for off in range(0, n, _TILE_ROWS):
            d2, idx = _knn_tile(xv[off : off + _TILE_ROWS], xv, pts_sq, off, kk)
            d2s.append(d2)
            idxs.append(idx)
        # the k·n surviving edges cross to the host once
        d2 = np.maximum(torch.cat(d2s).cpu().numpy().reshape(-1), 0.0)
        cols = torch.cat(idxs).cpu().numpy().reshape(-1)
        rows = np.repeat(np.arange(n), kk)
        if weights == "rbf":
            vals = np.exp(-d2 / (2.0 * float(sigma) ** 2)).astype(np.float32)
        elif weights == "distance":
            vals = np.sqrt(d2).astype(np.float32)
        else:
            vals = np.ones(len(rows), np.float32)
        W = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
        if symmetrize:
            W = W.maximum(W.T).tocsr()
    else:
        W = scipy.sparse.csr_matrix((n, n), dtype=np.float32)
    # explicit zero diagonal: COO assembly keeps explicit zeros, so every
    # vertex owns a diagonal slot for the Laplacian's value transform
    Wc = W.tocoo()
    W = scipy.sparse.csr_matrix(
        (
            np.concatenate([Wc.data.astype(np.float32), np.zeros(n, np.float32)]),
            (np.concatenate([Wc.row, np.arange(n)]), np.concatenate([Wc.col, np.arange(n)])),
        ),
        shape=(n, n),
    )
    telemetry.record_event(
        "knn_graph", n=n, k=kk, nnz=int(W.nnz), density=round(W.nnz / max(n * n, 1), 6), weights=weights,
        symmetrize=bool(symmetrize),
    )
    out = sparse_csr_matrix(
        W, split=split, device=device, comm=comm,
        min_row_cap=(2 * (kk + 1) if bucket_cap else 0), pow2_cap=bucket_cap,
    )
    out._graph_meta = {"knn_k": kk, "weights": weights, "has_diagonal": True}
    return out
