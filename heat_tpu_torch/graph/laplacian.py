"""Graph Laplacians from similarity matrices (counterpart of
heat_tpu/graph/laplacian.py).

:func:`laplacian_sparse` maps a DCSR affinity graph to its Laplacian
without densifying it.  When every vertex carries an explicit diagonal
entry (``sparse.knn_graph`` builds them) it is a value transform on each
position's device: the degrees from one diagonal-excluding segment sum,
then ``-A_ij·d_i^-1/2·d_j^-1/2`` off the diagonal and the I (or D) term in
the diagonal slot, so the Laplacian keeps the affinity's structure.
Without a full diagonal the Laplacian is rebuilt on the host with scipy,
as the JAX package does.  :class:`Laplacian` builds the dense Laplacian of
a dense similarity, or the sparse one of a DCSR similarity.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import types
from ..core.dndarray import DNDarray, _wrap
from ..parallel import collectives
from ..sparse._operations import _expand_rows
from ..sparse.dcsr_matrix import DCSR_matrix

__all__ = ["Laplacian", "laplacian_sparse"]


def _no_self_loops(A: torch.Tensor) -> torch.Tensor:
    """A copy of ``A`` with a zero diagonal."""
    return A.clone().fill_diagonal_(0)


def _norm_sym_L(A: torch.Tensor) -> torch.Tensor:
    """Self-loops removed, L_sym = I − D^-1/2 A D^-1/2."""
    A = _no_self_loops(A)
    degree = torch.sum(A, dim=1)
    d_inv_sqrt = torch.where(degree > 0, 1.0 / torch.sqrt(degree), torch.zeros((), dtype=A.dtype, device=A.device))
    L = -A * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    return L + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)


def _simple_L(A: torch.Tensor) -> torch.Tensor:
    """Self-loops removed, L = D − A."""
    A = _no_self_loops(A)
    return torch.diag(torch.sum(A, dim=1)) - A


# ------------------------------------------------------------ sparse path


def _binarize(data: torch.Tensor, weighted: bool) -> torch.Tensor:
    return data if weighted else (data != 0).to(data.dtype)


def _has_full_diagonal(A: DCSR_matrix) -> bool:
    """True iff every row holds an explicit diagonal entry (zero or not).
    Graph factories stamp it (``_graph_meta``); any other matrix pays one
    host scan of its structure."""
    meta = getattr(A, "_graph_meta", None)
    if meta and meta.get("has_diagonal"):
        return True
    n = A.shape[0]
    _, idx, ptr = A._assemble()
    rows_of = np.repeat(np.arange(n), np.diff(ptr))
    has = np.zeros(n, bool)
    has[rows_of[idx == rows_of]] = True
    return bool(has.all())


def laplacian_sparse(A: DCSR_matrix, definition: str = "norm_sym", weighted: bool = True) -> DCSR_matrix:
    """Laplacian of a sparse affinity graph, sparse in and sparse out
    (float32).  Self-loops are dropped, as in the dense Laplacians."""
    if definition not in ("simple", "norm_sym"):
        raise NotImplementedError("Only simple and normalized symmetric graph laplacians are supported")
    n, m = A.shape
    if n != m:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    if not _has_full_diagonal(A):
        import scipy.sparse

        from ..sparse.factories import sparse_csr_matrix

        sp = A.to_scipy().astype(np.float32)
        sp.setdiag(0.0)
        sp.eliminate_zeros()
        if not weighted:
            sp.data = (sp.data != 0).astype(np.float32)
        deg = np.asarray(sp.sum(axis=1)).ravel()
        if definition == "norm_sym":
            dis = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
            Dm = scipy.sparse.diags(dis)
            L = scipy.sparse.eye(n, dtype=np.float32) - Dm @ sp @ Dm
        else:
            L = scipy.sparse.diags(deg) - sp
        return sparse_csr_matrix(L.tocsr().astype(np.float32), split=A.split, device=A.device, comm=A.comm)

    # per position: global rows of the entries, the diagonal mask, the
    # binarized values; then the degrees over the whole mesh
    parts, degs = [], []
    for r, (data, idx, ptr) in enumerate(A._shards):
        lo, _ = A._row_range(r)
        row_g = _expand_rows(ptr, data.numel()) + lo
        diag = idx.to(torch.int64) == row_g
        a = _binarize(data.to(torch.float32), weighted)
        deg = torch.zeros(ptr.numel() - 1, dtype=torch.float32, device=data.device)
        deg.index_add_(0, row_g - lo, torch.where(diag, torch.zeros_like(a), a))
        parts.append((row_g, diag, a, idx, ptr))
        degs.append(deg)
    deg = collectives.all_gather(degs)[0]
    dis = torch.where(deg > 0, 1.0 / torch.sqrt(deg), torch.zeros_like(deg))
    shards = []
    for row_g, diag, a, idx, ptr in parts:
        if definition == "norm_sym":
            new = torch.where(diag, torch.ones_like(a), -a * dis[row_g] * dis[idx.to(torch.int64)])
        else:
            new = torch.where(diag, deg[row_g], -a)
        shards.append((new, idx, ptr))
    out = DCSR_matrix._from_shards(shards, A.shape, types.float32, A.split, A.device, A.comm)
    out._graph_meta = {"has_diagonal": True, "laplacian": definition}
    return out


class Laplacian:
    """Builds L = D − A (``"simple"``) or L = I − D^-1/2 A D^-1/2
    (``"norm_sym"``) from a similarity metric.

    ``mode`` is ``"fully_connected"`` or ``"eNeighbour"``, which keeps the
    similarities below (``threshold_key="upper"``) or above (``"lower"``)
    ``threshold_value``; ``weighted=False`` binarizes the adjacency.
    ``neighbours`` is accepted for parity.  A metric that returns a
    :class:`DCSR_matrix` (e.g. ``sparse.knn_graph``) gives a DCSR
    Laplacian, never densified."""

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError("Only simple and normalized symmetric graph laplacians are supported")
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError("Only eNeighbour and fully-connected graphs are supported")
        if threshold_key not in ("upper", "lower"):
            raise ValueError(f'threshold_key must be "upper" or "lower", got {threshold_key!r}')
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def construct(self, X: DNDarray):
        """The Laplacian of the dataset ``X``."""
        S = self.similarity_metric(X)
        if isinstance(S, DCSR_matrix):
            if self.mode != "fully_connected":
                raise NotImplementedError(
                    "eNeighbour thresholding is not defined for sparse affinity graphs (the graph IS the neighbourhood)"
                )
            return laplacian_sparse(S, definition=self.definition, weighted=self.weighted)
        A = S.larray
        if self.mode == "eNeighbour":
            key, value = self.epsilon
            keep = A < value if key == "upper" else A > value
            A = torch.where(keep, A if self.weighted else torch.ones_like(A), torch.zeros((), dtype=A.dtype, device=A.device))
        L = _norm_sym_L(A) if self.definition == "norm_sym" else _simple_L(A)
        return _wrap(L, S.split, X.device, X.comm)
