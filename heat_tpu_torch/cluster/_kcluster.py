"""Shared k-clustering base (counterpart of heat_tpu/cluster/_kcluster.py):
centroid initialisation (explicit, ``"random"``, ``"kmeans++"``), the
nearest-centroid assignment with its inertia, ``predict``, and the
KMedians/KMedoids loop.

The median loop (heat_tpu's ``_median_loop`` :97) runs on the row blocks of
the positions: L1 labels (``spatial.distance._l1``, a block of rows at a
time, never the (n, k, f) broadcast), then each cluster's per-feature
median, and for KMedoids the snap of each median to its nearest sample
through K1.  The medians are exact selections: the rows are grouped by
label once (on a mesh, the gather an all-to-all by label would make), and
each cluster's two middle order statistics, at (cnt − 1)//2 and cnt//2, are
selected per feature (``torch.kthvalue``) and averaged as
``(lo + hi) * 0.5`` in the data's type, so they equal heat_tpu's sorts bit
for bit; an empty cluster keeps its old centre.  The loop reads one small
vector per iteration: whether the last shift exceeded ``tol``, and the
cluster counts of the labels just taken (the JAX package keeps the loop on
the device).  So a fit that stops on ``tol`` takes one L1 pass more than
its iterations."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..core import random as ht_random
from ..core import sanitation, statistics, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..ops import cdist as _k1
from ..parallel import collectives
from ..spatial.distance import _l1

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


def _k1_input(t: torch.Tensor) -> torch.Tensor:
    """A block as K1 takes it: f32 and 16-bit floats as they are (K1 widens
    16-bit tiles itself, so no f32 copy of them exists), float64 as f32
    (the TPU kernel computes in f32 whatever its input)."""
    return t.to(torch.float32) if t.dtype == torch.float64 else t


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
    d = [_k1.cdist(_k1_input(b), _k1_input(c0), sqrt=True)[:, 0] for b in blocks]
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
        d = [torch.minimum(di, _k1.cdist(_k1_input(b), _k1_input(cj), sqrt=True)[:, 0]) for di, b in zip(d, blocks)]
    return torch.stack(centers)


def _l1_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) Manhattan distances in x's type (heat_tpu's ``_l1_dist`` :51),
    a block of rows at a time."""
    return _l1(x, centers.to(x.dtype))


def _l1_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Labels by Manhattan distance, the first nearest centre on ties."""
    return torch.argmin(_l1_dist(x, centers), dim=1)


def _counts(labels: List[torch.Tensor], k: int) -> torch.Tensor:
    """Rows a cluster, summed over the positions (int64, (k,))."""
    return collectives.psum([torch.bincount(lab, minlength=k) for lab in labels])[0]


def _masked_medians(blocks: List[torch.Tensor], labels: List[torch.Tensor], k: int, fallback: torch.Tensor,
                    counts: Optional[List[int]] = None) -> torch.Tensor:
    """Per-cluster, per-feature median of the rows assigned to each cluster
    (heat_tpu's ``_masked_medians`` :26): the values at positions
    (cnt − 1)//2 and cnt//2 of the cluster's sorted column, averaged as
    ``(lo + hi) * 0.5`` in the rows' type; ``fallback[j]`` for an empty
    cluster.  The rows of all positions are grouped by label once; each
    cluster's order statistics are then selected from its (f, cnt) copy.
    ``counts`` (host ints) are read from the labels when not given."""
    dev = blocks[0].device
    x = torch.cat([b.to(dev) for b in blocks]) if len(blocks) > 1 else blocks[0]
    lab = torch.cat([b.to(dev) for b in labels]) if len(labels) > 1 else labels[0]
    if counts is None:
        counts = torch.bincount(lab, minlength=k).tolist()
    grouped = x[torch.argsort(lab)]
    meds = fallback.to(device=dev, dtype=x.dtype).clone()
    start = 0
    for j, cnt in enumerate(counts):
        if cnt:
            seg = grouped[start : start + cnt].T.contiguous()
            lo = torch.kthvalue(seg, (cnt - 1) // 2 + 1, dim=1).values
            hi = lo if cnt % 2 else torch.kthvalue(seg, cnt // 2 + 1, dim=1).values
            meds[j] = (lo + hi) * 0.5
        start += cnt
    return meds


def _snap(blocks: List[torch.Tensor], medians: torch.Tensor, counts: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """Each median moved to its nearest sample (heat_tpu's KMedoids step
    :114-118): K1's squared distances of every position's rows to the
    medians (one launch a position), the first nearest row over the
    positions (F1's rule: strictly nearer replaces, so a tie keeps the
    earlier row), taken on the device; an empty cluster keeps ``old``."""
    best_v = best_row = None
    for b in blocks:
        if b.shape[0] == 0:
            continue
        d2 = _k1.cdist(_k1_input(b), _k1_input(medians.to(b.device)), sqrt=False)
        v, i = torch.min(d2, dim=0)
        row = b[i]
        if best_v is None:
            best_v, best_row = v, row
        else:
            v, row = v.to(best_v.device), row.to(best_row.device)
            take = (v < best_v) | (torch.isnan(v) & ~torch.isnan(best_v))
            best_v = torch.where(take, v, best_v)
            best_row = torch.where(take[:, None], row, best_row)
    dev = best_row.device
    return torch.where(counts.to(dev)[:, None] > 0, best_row, old.to(device=dev, dtype=best_row.dtype))


def _median_loop(blocks: List[torch.Tensor], centers: torch.Tensor, k: int, max_iter: int, tol: float,
                 snap_to_sample: bool):
    """KMedians (KMedoids with ``snap_to_sample``) iterations
    (heat_tpu's ``_median_loop`` :97) while ``it < max_iter`` and
    ``shift > tol``, from ``shift = inf`` (``tol=-1`` runs exactly
    ``max_iter`` steps, KMedoids' ``tol=0`` stops when the medoids stop
    moving).  ``shift = Σ(new − centers)²`` in the data's type.  Returns
    (centers, shift, n_iter)."""
    dev = centers.device
    shift = torch.tensor(float("inf"), dtype=centers.dtype, device=dev)
    it = 0
    while it < max_iter:
        labels = [_l1_assign(b, centers.to(b.device)) for b in blocks]
        counts = _counts(labels, k).to(dev)
        # the one read of the iteration: the last shift's test and the counts
        flags = torch.cat([(shift > tol).to(torch.int64)[None], counts]).tolist()
        if not flags[0]:
            break
        new = _masked_medians(blocks, labels, k, centers, counts=flags[1:]).to(dev)
        if snap_to_sample:
            new = _snap(blocks, new, counts, centers)
        shift = torch.sum((new - centers) ** 2)
        centers = new
        it += 1
    return centers, shift, it


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

    def _initial_centroids(self, blocks: List[torch.Tensor], n: int, f: int, device, comm,
                           seed_blocks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Initial centroids (heat_tpu/cluster/_kcluster.py:168) of the n rows
        of width f held in ``blocks``: explicit ones as given, "random" one
        row per stratum [i*n/k, (i+1)*n/k), kmeans++ over ``seed_blocks``
        (default: all the rows)."""
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        k = self.n_clusters
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}")
        if isinstance(self.init, DNDarray):
            if self.init.ndim != 2:
                raise ValueError("passed centroids need to be two-dimensional")
            if self.init.shape[0] != k or self.init.shape[1] != f:
                raise ValueError("passed centroids do not match cluster count or data shape")
            return self.init.resplit(None).larray.to(blocks[0].device)
        if not (isinstance(self.init, str) and self.init in ("random", "probability_based", "kmeans++")):
            raise ValueError(
                f'init needs to be "random", "kmeans++"/"probability_based" or a '
                f"DNDarray, but was {self.init!r}"
            )
        # uniforms stay float32 whatever the data dtype
        us = ht_random.rand(k, device=device, comm=comm).larray
        if self.init == "random":
            lo = torch.arange(k, device=us.device) * (n // k)
            idx = torch.clamp(lo + (us * max(n // k, 1)).to(torch.int64), max=n - 1)
            return _rows(blocks, idx.tolist())
        return _kmeanspp_init(blocks if seed_blocks is None else seed_blocks, us, k)

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Initial centroids of the rows of ``x``, replicated."""
        # explicit centroids need only the rows' device: no resplit for them
        blocks = x.shards[:1] if isinstance(self.init, DNDarray) else _row_blocks(x)
        centroids = self._initial_centroids(blocks, x.shape[0], x.shape[1], x.device, x.comm)
        self._cluster_centers = DNDarray(
            [centroids] * x.comm.size, tuple(centroids.shape),
            types.canonical_heat_type(centroids.dtype), None, x.device, x.comm,
        )

    def _assign_to_cluster(self, x: DNDarray, return_inertia: bool = False):
        """Index of the closest centroid for each sample, as an (n, 1) array
        split like ``x`` (heat_tpu/cluster/_kcluster.py:219); with
        ``return_inertia`` also the sum of the row minima of the metric,
        read back once."""
        distances = self._metric(x, self._cluster_centers)
        labels = statistics.argmin(distances, axis=1, keepdims=True)
        if return_inertia:
            inertia = float(statistics.min(distances, axis=1).sum().item())
        if labels.split != x.split:
            labels.resplit_(x.split)
        return (labels, inertia) if return_inertia else labels

    def _fit_median_loop(self, x: DNDarray, snap_to_sample: bool):
        """The KMedians/KMedoids fit (heat_tpu/cluster/_kcluster.py:251):
        initialise, run :func:`_median_loop` over the row blocks, then the
        labels and inertia against the final centres."""
        sanitation.sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-D, but was {x.ndim}-D")
        self._initialize_cluster_centers(x)
        blocks = _row_blocks(x)
        centers = self._cluster_centers.larray.to(device=blocks[0].device, dtype=blocks[0].dtype)
        centers, _, n_iter = _median_loop(blocks, centers, self.n_clusters, self.max_iter, self.tol, snap_to_sample)
        self._n_iter = n_iter
        self._cluster_centers = DNDarray(
            [centers] * x.comm.size, tuple(centers.shape),
            types.canonical_heat_type(centers.dtype), None, x.device, x.comm,
        )
        self._labels, self._inertia = self._assign_to_cluster(x, return_inertia=True)
        return self

    def _label_blocks(self, x: DNDarray, matching_centroids: DNDarray):
        """The row blocks of ``x`` (float), its labels cut like them, and the
        current centres in the rows' type, for ``_update_centroids``."""
        blocks = _row_blocks(x)
        labels = list(torch.split(
            matching_centroids.larray.reshape(-1).to(blocks[0].device),
            [b.shape[0] for b in blocks],
        ))
        old = self._cluster_centers.larray.to(device=blocks[0].device, dtype=blocks[0].dtype)
        return blocks, labels, old

    def predict(self, x: DNDarray) -> DNDarray:
        """Closest-cluster index for each sample."""
        sanitation.sanitize_in(x)
        if self._cluster_centers is None:
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet; call fit() before predict()"
            )
        return self._assign_to_cluster(x)
