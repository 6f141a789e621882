"""K-Means clustering with Lloyd's algorithm (counterpart of
heat_tpu/cluster/kmeans.py).

One Lloyd step runs per position on its block of rows: K1 gives the squared
distances to the centres, then argmin, the one-hot counts and the one-hot
sums, all in torch on the block's device; the counts, sums and inertia are
all-reduced over the positions, and the centre update follows.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..core import sanitation, types
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives
from ..spatial import distance
from ._kcluster import _KCluster, _f32, _row_blocks

__all__ = ["KMeans"]


def _lloyd_step(blocks: List[torch.Tensor], centers: torch.Tensor, k: int):
    """One Lloyd iteration (heat_tpu/cluster/kmeans.py:90): returns
    (new_centers, shift², inertia), the last two as f32 scalars.  Inertia is
    the sum of each row's distance to its nearest centre BEFORE the update."""
    counts, sums, inertia = [], [], []
    for xs in blocks:
        d2 = _k1.cdist(_f32(xs), _f32(centers), sqrt=False)
        labels = torch.argmin(d2, dim=1)
        onehot = (labels[:, None] == torch.arange(k, device=xs.device)[None, :]).to(xs.dtype)
        # counts and sums accumulate in f32 whatever the data dtype; the 0/1
        # products are exact, only the accumulator needs the width
        counts.append(torch.sum(onehot, dim=0, dtype=torch.float32))
        sums.append(torch.matmul(onehot.T, xs).to(torch.float32))
        inertia.append(torch.sum(torch.amin(d2, dim=1)))
    counts = collectives.psum(counts)[0]
    sums = collectives.psum(sums)[0]
    inertia = collectives.psum(inertia)[0]
    new_centers = torch.where(
        counts[:, None] > 0,
        sums / torch.clamp(counts, min=1)[:, None],
        centers.to(torch.float32),
    ).to(centers.dtype)
    shift = torch.sum((new_centers - centers).to(torch.float32) ** 2)
    return new_centers, shift, inertia


def _lloyd_loop(blocks: List[torch.Tensor], centers: torch.Tensor, k: int, max_iter: int, tol: float):
    """Iterate :func:`_lloyd_step` while ``it < max_iter`` and
    ``shift² > tol``, from ``shift = inf`` (so ``tol=-1`` runs exactly
    ``max_iter`` steps).  The test reads shift back to the host once per
    iteration; the JAX package keeps the whole loop on the device.  Returns
    (centers, shift, inertia, n_iter) with f32 shift and inertia."""
    dev = centers.device
    shift = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    inertia = torch.tensor(0.0, dtype=torch.float32, device=dev)
    it = 0
    # shift > tol compares in f32, as the JAX loop's carry does
    while it < max_iter and bool(shift > tol):
        centers, shift, inertia = _lloyd_step(blocks, centers, k)
        it += 1
    return centers, shift, inertia, it


class KMeans(_KCluster):
    """K-Means with Lloyd's algorithm.

    ``n_clusters``, ``init`` ("random", "kmeans++"/"probability_based", or
    explicit centroids as a DNDarray), ``max_iter``, ``tol`` (on the squared
    centroid shift) and ``random_state`` mirror heat_tpu.cluster.KMeans.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmeans++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.cdist(x, y, quadratic_expansion=True),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def _update_centroids(self, x: DNDarray, matching_centroids: DNDarray) -> DNDarray:
        """Masked-mean centroid update from given labels
        (heat_tpu/cluster/kmeans.py:452); ``fit`` uses the fused step."""
        k = self.n_clusters
        blocks = _row_blocks(x)
        labels = torch.split(
            matching_centroids.larray.reshape(-1).to(blocks[0].device),
            [b.shape[0] for b in blocks],
        )
        counts, sums = [], []
        for xs, lab in zip(blocks, labels):
            onehot = (lab[:, None] == torch.arange(k, device=xs.device)[None, :]).to(xs.dtype)
            counts.append(torch.sum(onehot, dim=0))
            sums.append(torch.matmul(onehot.T, xs))
        counts = collectives.psum(counts)[0]
        sums = collectives.psum(sums)[0]
        old = self._cluster_centers.larray
        new = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1)[:, None], old)
        return DNDarray(
            [new] * x.comm.size, tuple(new.shape), types.canonical_heat_type(new.dtype),
            None, x.device, x.comm,
        )

    def fit(self, x: DNDarray) -> "KMeans":
        """Lloyd iterations until the squared centroid shift is at most
        ``tol``, or ``max_iter``."""
        sanitation.sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-D, but was {x.ndim}-D")
        if x.dtype in (types.float16, types.bfloat16):
            raise NotImplementedError(
                "half-precision KMeans input takes the lane-packed path, which the "
                "port has not reached yet (ROADMAP queue 1, item 5)"
            )
        self._initialize_cluster_centers(x)
        blocks = _row_blocks(x)
        centers = self._cluster_centers.larray.to(blocks[0].dtype)
        centers, _, inertia, n_iter = _lloyd_loop(
            blocks, centers, self.n_clusters, self.max_iter, self.tol
        )
        self._n_iter = n_iter
        self._cluster_centers = DNDarray(
            [centers] * x.comm.size, tuple(centers.shape),
            types.canonical_heat_type(centers.dtype), None, x.device, x.comm,
        )
        self._labels = self._assign_to_cluster(x)
        self._inertia = float(inertia)
        return self
