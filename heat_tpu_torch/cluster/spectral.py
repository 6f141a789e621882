"""Spectral clustering (counterpart of heat_tpu/cluster/spectral.py).

The pipeline: a similarity graph, its normalised Laplacian, a Lanczos
tridiagonalisation, ``torch.linalg.eigh`` of the small tridiagonal T, and
KMeans on the first ``n_clusters`` columns of the embedding.

* ``affinity="rbf"`` (dense): the (n, n) Gaussian similarity over K1
  (``spatial.rbf``), the dense Laplacian, Lanczos over dense products;
* ``affinity="knn"`` (sparse): the k-NN graph (``sparse.knn_graph``), the
  DCSR Laplacian (``graph.laplacian_sparse``) and Lanczos over K6, from a
  deterministic start vector; the (n, n) similarity never exists.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sanitation
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray, _wrap
from ..core.linalg import solver
from ..graph.laplacian import Laplacian
from ..sparse.dcsr_matrix import DCSR_matrix
from ..sparse.knn import knn_graph
from ..spatial import distance
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering on a similarity graph.

    ``gamma`` sets the Gaussian width σ = (1/2γ)^½; ``laplacian``,
    ``threshold`` and ``boundary`` choose the dense graph
    (``"fully_connected"`` or ``"eNeighbour"``); ``n_lanczos`` is the
    Krylov dimension; ``affinity`` is ``"rbf"`` or ``"knn"`` with
    ``n_neighbors``.  Without ``n_clusters`` the largest eigen-gap picks it.
    ``params={"params": {...}}`` passes KMeans its parameters."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        affinity: str = "rbf",
        n_neighbors: int = 10,
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels
        self.affinity = affinity
        self.n_neighbors = n_neighbors

        if metric != "rbf":
            raise NotImplementedError(f"only the rbf metric is supported, got {metric!r}")
        if affinity not in ("rbf", "knn"):
            raise NotImplementedError(f'affinity must be "rbf" (dense) or "knn" (sparse), got {affinity!r}')
        sigma = (1.0 / (2.0 * gamma)) ** 0.5
        if affinity == "knn":
            similarity = lambda x: knn_graph(
                x, n_neighbors, weights="rbf", sigma=sigma, bucket_cap=True,
                split=x.split if x.split == 0 else None,
            )
        else:
            similarity = lambda x: distance.rbf(x, sigma=sigma, quadratic_expansion=True)
        self._laplacian = Laplacian(
            similarity, definition="norm_sym", mode=laplacian,
            threshold_key=boundary, threshold_value=threshold,
        )
        if assign_labels != "kmeans":
            raise NotImplementedError(f"only kmeans label assignment is supported, got {assign_labels!r}")
        kmeans_params = params.get("params", {"n_clusters": n_clusters, "init": "kmeans++"})
        if n_clusters is not None:
            kmeans_params["n_clusters"] = n_clusters
        self._cluster = KMeans(**kmeans_params)
        self._labels = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """(eigenvalues of T ascending, the embedding V·evecs (n, m))."""
        L = self._laplacian.construct(x)
        n = L.shape[0]
        m = min(self.n_lanczos, n)
        if isinstance(L, DCSR_matrix):
            # a deterministic start vector with no structure (a sin ramp):
            # the all-ones vector would lie close to the trivial eigenvector
            raw = torch.sin(torch.arange(1, n + 1, dtype=torch.float32, device=x.device.torch_device))
            V, T = solver.lanczos(L, m, v0=_wrap(raw, None, x.device, x.comm))
        else:
            V, T = solver.lanczos(L, m)
        evals, evecs = torch.linalg.eigh(T.larray)
        return evals, V.larray @ evecs

    def _embed(self, x: DNDarray, evecs: torch.Tensor) -> DNDarray:
        # row-major: KMeans hands its row blocks to K1 as they are
        return _wrap(evecs[:, : self.n_clusters].contiguous(), x.split, x.device, x.comm)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed ``x`` and cluster the embedding."""
        sanitation.sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-D, but was {x.ndim}-D")
        evals, evecs = self._spectral_embedding(x)
        if self.n_clusters is None:
            # the largest eigen-gap (one host read)
            self.n_clusters = int(torch.argmax(torch.diff(evals))) + 1
            self._cluster.n_clusters = self.n_clusters
        self._cluster.fit(self._embed(x, evecs))
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Embed ``x`` anew and assign each row to the fitted KMeans centre
        nearest to it in the embedding."""
        sanitation.sanitize_in(x)
        if self._cluster.cluster_centers_ is None:
            raise RuntimeError("fit the model first")
        if x.split is not None and x.split != 0:
            raise NotImplementedError("Not implemented for other splitting-axes")
        _, evecs = self._spectral_embedding(x)
        return self._cluster.predict(self._embed(x, evecs))
