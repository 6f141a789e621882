"""Shared k-clustering base (counterpart of heat_tpu/cluster/_kcluster.py):
centroid initialisation (explicit, ``"random"``, ``"kmeans++"``), the
nearest-centroid assignment and ``predict``."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..core import random as ht_random
from ..core import sanitation, statistics, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives

__all__ = ["_KCluster"]


def _row_blocks(x: DNDarray) -> List[torch.Tensor]:
    """The rows of ``x`` as one block per position (one block when ``x`` is
    replicated), non-float data cast to float32."""
    if x.split is None:
        blocks = [x.shards[0]]
    else:
        blocks = (x if x.split == 0 else x.resplit(0)).shards
    return [b if b.is_floating_point() else b.to(torch.float32) for b in blocks]


def _rows(blocks: List[torch.Tensor], idx: List[int]) -> torch.Tensor:
    """Global rows ``idx`` of the row blocks, stacked in that order."""
    starts, out = [], []
    off = 0
    for b in blocks:
        starts.append(off)
        off += b.shape[0]
    for i in idx:
        r = max(j for j, s in enumerate(starts) if s <= i and blocks[j].shape[0] > 0)
        out.append(blocks[r][i - starts[r]])
    return torch.stack(out)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """K1 takes float32 (the JAX kernel upcasts every dtype to f32 too)."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _kmeanspp_init(blocks: List[torch.Tensor], us: torch.Tensor, k: int) -> torch.Tensor:
    """Distance-weighted (kmeans++) seeding over row blocks
    (heat_tpu/cluster/_kcluster.py:63): each round draws the next centre with
    probability proportional to the Euclidean distance to the nearest chosen
    one, carried as a running minimum, so a round costs one (n, 1) distance
    column.  Each round reads its chosen index back to the host, k reads in
    all; the JAX package runs all rounds in one program."""
    n = sum(b.shape[0] for b in blocks)
    first = min(int((us[0] * n).to(torch.int64)), n - 1)
    c0 = _rows(blocks, [first])
    centers = [c0[0]]
    d = [_k1.cdist(_f32(b), _f32(c0), sqrt=True)[:, 0] for b in blocks]
    for j in range(1, k):
        # position of us[j] in cumsum(d / total) over the concatenated blocks:
        # per-block cumsums shifted by the mass of the blocks before them.
        # The CDF is summed in float64: in float32 a point's share (~1/n) is
        # about one ulp of the running sum at n ~ 1e7, so the sum drifts far
        # from the CDF, and the card's scan, whose order of partial sums
        # varies between runs, would pick another point on every run.
        total = collectives.psum([di.sum(dtype=torch.float64) for di in d])[0]
        below = torch.zeros((), dtype=torch.int64, device=us.device)
        offset = torch.zeros((), dtype=torch.float64, device=us.device)
        u = us[j : j + 1].to(torch.float64)
        for di in d:
            cum = torch.cumsum(di.to(torch.float64) / total, dim=0) + offset
            below = below + torch.searchsorted(cum, u)[0]
            if cum.numel():
                offset = cum[-1]
        nxt = min(int(below), n - 1)
        cj = _rows(blocks, [nxt])
        centers.append(cj[0])
        d = [torch.minimum(di, _k1.cdist(_f32(b), _f32(cj), sqrt=True)[:, 0]) for di, b in zip(d, blocks)]
    return torch.stack(centers)


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class for k-statistics clustering."""

    def __init__(
        self,
        metric: Callable,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int],
    ):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        """Coordinates of the cluster centers (replicated)."""
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Pick initial centroids (heat_tpu/cluster/_kcluster.py:168)."""
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        k = self.n_clusters
        n = x.shape[0]
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}")

        if isinstance(self.init, DNDarray):
            if self.init.ndim != 2:
                raise ValueError("passed centroids need to be two-dimensional")
            if self.init.shape[0] != k or self.init.shape[1] != x.shape[1]:
                raise ValueError("passed centroids do not match cluster count or data shape")
            centroids = self.init.resplit(None).larray.to(x.shards[0].device)
        elif isinstance(self.init, str) and self.init in ("random", "probability_based", "kmeans++"):
            blocks = _row_blocks(x)
            # uniforms stay float32 whatever the data dtype
            us = ht_random.rand(k, device=x.device, comm=x.comm).larray
            if self.init == "random":
                # one sample per stratum [i*n/k, (i+1)*n/k)
                lo = torch.arange(k, device=us.device) * (n // k)
                idx = torch.clamp(lo + (us * max(n // k, 1)).to(torch.int64), max=n - 1)
                centroids = _rows(blocks, idx.tolist())
            else:
                centroids = _kmeanspp_init(blocks, us, k)
        else:
            raise ValueError(
                f'init needs to be "random", "kmeans++"/"probability_based" or a '
                f"DNDarray, but was {self.init!r}"
            )
        self._cluster_centers = DNDarray(
            [centroids] * x.comm.size, tuple(centroids.shape),
            types.canonical_heat_type(centroids.dtype), None, x.device, x.comm,
        )

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Index of the closest centroid for each sample, as an (n, 1) array
        split like ``x`` (heat_tpu/cluster/_kcluster.py:219)."""
        distances = self._metric(x, self._cluster_centers)
        labels = statistics.argmin(distances, axis=1, keepdims=True)
        if labels.split != x.split:
            labels.resplit_(x.split)
        return labels

    def predict(self, x: DNDarray) -> DNDarray:
        """Closest-cluster index for each sample."""
        sanitation.sanitize_in(x)
        if self._cluster_centers is None:
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet; call fit() before predict()"
            )
        return self._assign_to_cluster(x)
