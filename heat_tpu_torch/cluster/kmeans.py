"""K-Means clustering with Lloyd's algorithm (counterpart of
heat_tpu/cluster/kmeans.py).

One Lloyd step runs per position on its block of rows: K1 gives the squared
distances to the centres, then argmin, the one-hot counts and the one-hot
sums, all in torch on the block's device; the counts, sums and inertia are
all-reduced over the positions, and the centre update follows.

16-bit data takes the same step with the values of heat_tpu's 16-bit paths
(``_lloyd_step`` :90 and ``_lloyd_loop_packed`` :142), not their 128-lane
layout: the centres are cast to the data's type and each update is rounded
back to it, labels come from K1's f32 distances, counts and sums are taken
in f32, and K1 reads the 16-bit blocks as they are.  No f32 copy of the
data exists.  A :class:`~heat_tpu_torch.cluster.packing.PackedSamples`
(heat_tpu's ``_fit_packed`` :559) is fitted on views of its samples, and its
``inertia_`` comes from a last labels pass against the final centres.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..core import sanitation, types
from ..core.dndarray import DNDarray, _wrap
from ..ops import cdist as _k1
from ..parallel import collectives
from ..spatial import distance
from ._kcluster import _KCluster, _k1_input, _row_blocks
from .packing import PackedSamples

__all__ = ["KMeans"]

# kmeans++ on packed samples seeds on this prefix of them
# (heat_tpu/cluster/kmeans.py:541-545)
_PACKED_SEED_SAMPLES = 1 << 18


# rows of a 16-bit block that one tensor-core partial of the one-hot sums
# spans on the card; the partials are then added in f32 on the CUDA cores
_SUM_ROWS = 4096


def _onehot_sums(onehot: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """onehotᵀ·xs, (k, f) in f32 (heat_tpu's ``preferred_element_type=f32``).
    A 16-bit block on the card takes one batched cuBLAS product of
    _SUM_ROWS-row slices with f32 outputs, summed in f32: a single product
    over 1e8 rows (split-K on the tensor cores) is off by ~2e-4 of the sums,
    the slices by ~3e-7, in the same time, and no f32 copy of the block
    exists.  On the CPU the block is widened first.  The 0/1 products are
    exact either way."""
    if xs.element_size() >= 4:
        return torch.matmul(onehot.T, xs).to(torch.float32)
    if not xs.is_cuda:
        return torch.matmul(onehot.T.to(torch.float32), xs.to(torch.float32))
    (m, k), f = onehot.shape, xs.shape[1]
    b = m // _SUM_ROWS
    whole = b * _SUM_ROWS
    parts = torch.bmm(
        onehot[:whole].reshape(b, _SUM_ROWS, k).transpose(1, 2),
        xs[:whole].reshape(b, _SUM_ROWS, f),
        out_dtype=torch.float32,
    )
    return parts.sum(0) + torch.mm(onehot[whole:].T, xs[whole:], out_dtype=torch.float32)


def _lloyd_step(blocks: List[torch.Tensor], centers: torch.Tensor, k: int, with_inertia: bool = True):
    """One Lloyd iteration (heat_tpu/cluster/kmeans.py:90): returns
    (new_centers, shift², inertia), the last two as f32 scalars.  Inertia is
    the sum of each row's distance to its nearest centre BEFORE the update
    (0 without ``with_inertia``, which skips its pass).  The centres have
    the data's type, and so does the update."""
    counts, sums, inertia = [], [], []
    for xs in blocks:
        d2 = _k1.cdist(_k1_input(xs), _k1_input(centers), sqrt=False)
        labels = torch.argmin(d2, dim=1)
        onehot = (labels[:, None] == torch.arange(k, device=xs.device)[None, :]).to(xs.dtype)
        # counts and sums accumulate in f32 whatever the data dtype; the 0/1
        # products are exact, only the accumulator needs the width
        counts.append(torch.sum(onehot, dim=0, dtype=torch.float32))
        sums.append(_onehot_sums(onehot, xs))
        if with_inertia:
            inertia.append(torch.sum(torch.amin(d2, dim=1)))
    counts = collectives.psum(counts)[0]
    sums = collectives.psum(sums)[0]
    inertia = collectives.psum(inertia)[0] if with_inertia else torch.zeros((), device=centers.device)
    new_centers = torch.where(
        counts[:, None] > 0,
        sums / torch.clamp(counts, min=1)[:, None],
        centers.to(torch.float32),
    ).to(centers.dtype)
    shift = torch.sum((new_centers - centers).to(torch.float32) ** 2)
    return new_centers, shift, inertia


def _lloyd_loop(
    blocks: List[torch.Tensor], centers: torch.Tensor, k: int, max_iter: int, tol: float, with_inertia: bool = True
):
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
        centers, shift, inertia = _lloyd_step(blocks, centers, k, with_inertia)
        it += 1
    return centers, shift, inertia, it


def _packed_labels(blocks: List[torch.Tensor], centers: torch.Tensor):
    """Nearest-centre labels (int32, one tensor per block) and the total
    inertia against ``centers``: each sample's clamped squared distance to
    its nearest centre, summed in f32 (heat_tpu's ``_packed_labels`` :948)."""
    labels, inertia = [], []
    for xs in blocks:
        d2 = _k1.cdist(_k1_input(xs), _k1_input(centers), sqrt=False)
        labels.append(torch.argmin(d2, dim=1).to(torch.int32))
        inertia.append(torch.sum(torch.amin(d2, dim=1)))
    return labels, collectives.psum(inertia)[0]


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

    def fit(self, x: Union[DNDarray, PackedSamples]) -> "KMeans":
        """Lloyd iterations until the squared centroid shift is at most
        ``tol``, or ``max_iter``.  Also takes :class:`PackedSamples`."""
        if isinstance(x, PackedSamples):
            return self._fit_packed(x)
        sanitation.sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-D, but was {x.ndim}-D")
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

    # ------------------------------------------------------ packed samples
    def _init_centers_packed(self, packed: PackedSamples, blocks: List[torch.Tensor]) -> torch.Tensor:
        """Initial centres of packed samples (heat_tpu/cluster/kmeans.py:521):
        the dense path's draws, kmeans++ seeded on the first 2^18 samples."""
        left = min(packed.n, min(packed.x2.shape[0], _PACKED_SEED_SAMPLES // packed.p) * packed.p)
        prefix = []
        for b in blocks:
            if left > 0 and b.shape[0]:
                prefix.append(b[:left])
                left -= prefix[-1].shape[0]
        return self._initial_centroids(blocks, packed.n, packed.f, packed.device, packed.comm, prefix)

    def _fit_packed(self, packed: PackedSamples) -> "KMeans":
        """heat_tpu's ``_fit_packed`` (:559): the Lloyd loop on the sample
        views without the per-iteration inertia, then ``labels_`` and
        ``inertia_`` from one labels pass against the final centres (that
        pass's definition of inertia, not the dense path's)."""
        blocks = packed.sample_blocks()
        centers = self._init_centers_packed(packed, blocks).to(blocks[0].dtype)
        centers, _, _, n_iter = _lloyd_loop(
            blocks, centers, self.n_clusters, self.max_iter, self.tol, with_inertia=False
        )
        self._n_iter = n_iter
        self._cluster_centers = DNDarray(
            [centers] * packed.comm.size, tuple(centers.shape),
            types.canonical_heat_type(centers.dtype), None, packed.device, packed.comm,
        )
        self._labels, inertia = self._predict_packed(packed, with_inertia=True)
        self._inertia = float(inertia)
        return self

    def _predict_packed(self, packed: PackedSamples, with_inertia: bool = False):
        """Labels of packed samples as a flat (n,) int32 array split like
        the samples (heat_tpu's ``_predict_packed`` :600), and the inertia
        against the current centres when asked."""
        blocks = packed.sample_blocks()
        centers = self._cluster_centers.larray.to(device=blocks[0].device, dtype=blocks[0].dtype)
        labels, inertia = _packed_labels(blocks, centers)
        split = None if packed.split is None else 0
        out = _wrap(torch.cat(labels), split, packed.device, packed.comm)
        return (out, inertia) if with_inertia else out

    def predict(self, x: Union[DNDarray, PackedSamples]) -> DNDarray:
        """Closest-cluster index for each sample; for packed samples a flat
        (n,) int32 array, as heat_tpu gives."""
        if isinstance(x, PackedSamples):
            if self._cluster_centers is None:
                raise RuntimeError("KMeans is not fitted yet; call fit() before predict()")
            return self._predict_packed(x)
        return super().predict(x)
