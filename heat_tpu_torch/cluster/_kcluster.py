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
its iterations.

Across processes (a split array on a comm that spans them) each process
holds its positions' row blocks and no process gathers the data: random
seeding broadcasts each chosen row from its owner; ++ seeding runs K1 on
this process's blocks and its f64 CDF from the gathered per-position sums
and last partial sums, chained in position order as one process chains
them, so the centres are the single controller's bit for bit; the medians
move each cluster's rows to one process (an all-to-all by label through
the exchange) and select there; KMedoids' snap combines each process's
nearest samples in position order."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..core import random as ht_random
from ..core import fusion, sanitation, statistics, types
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
        rows = x if x.split == 0 else x._resplit(0, exact=True)
        # on a process comm: this process's positions, whose partials the
        # collectives' process route combines
        blocks = rows.comm.local_shards(rows.shards)
    return [b if b.is_floating_point() else b.to(torch.float32) for b in blocks]


def _sizes(comm, n: int) -> List[int]:
    """Every position's rows of an n-row split-0 array (the chunk rule)."""
    return [int(e) for e in comm.lshape_map((n, 1), 0)[:, 0]]


def _rows(blocks: List[torch.Tensor], idx: List[int], comm=None, n: Optional[int] = None) -> torch.Tensor:
    """Global rows ``idx`` of the row blocks, stacked in that order.  With
    a ``comm`` that spans processes the blocks are this process's
    positions' of an ``n``-row array: each process gives the rows it owns,
    in one gather, and every process gets them all."""
    if comm is not None and comm.spans_processes:
        sizes = _sizes(comm, n)
        starts = [sum(sizes[:r]) for r in range(comm.size)]
        owner = [max(r for r in range(comm.size) if starts[r] <= i and sizes[r] > 0) for i in idx]
        order = sorted(range(len(idx)), key=lambda j: owner[j])  # stable: idx order within an owner
        mine = {r: [blocks[k][idx[j] - starts[r]] for j in order if owner[j] == r]
                for k, r in enumerate(comm.local_positions)}
        like = next(b for b in blocks if b is not None)
        parts = [torch.stack(mine[r]) if mine[r] else like[:0] for r in comm.local_positions]
        got = collectives.all_gather(parts, comm=comm, lengths=[owner.count(r) for r in range(comm.size)])[0]
        out = torch.empty_like(got)
        out[torch.tensor(order, dtype=torch.int64, device=got.device)] = got
        return out
    starts, out = [], []
    off = 0
    for b in blocks:
        starts.append(off)
        off += b.shape[0]
    for i in idx:
        r = max(j for j, s in enumerate(starts) if s <= i and blocks[j].shape[0] > 0)
        out.append(blocks[r][i - starts[r]])
    return torch.stack(out)


def _rows_comm(x: DNDarray):
    """``x``'s comm when its rows are spread over processes (a split array
    on a comm that spans them), else None."""
    return x.comm if x.split is not None and x.comm.spans_processes else None


def _k1_input(t: torch.Tensor) -> torch.Tensor:
    """A block as K1 takes it: f32 and 16-bit floats as they are (K1 widens
    16-bit tiles itself, so no f32 copy of them exists), float64 as f32
    (the TPU kernel computes in f32 whatever its input)."""
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _kmeanspp_init(blocks: List[torch.Tensor], us: torch.Tensor, k: int, comm=None, n: Optional[int] = None) -> torch.Tensor:
    """Distance-weighted (kmeans++) seeding over row blocks
    (heat_tpu/cluster/_kcluster.py:63): each round draws the next centre with
    probability proportional to the Euclidean distance to the nearest chosen
    one, carried as a running minimum, so a round costs one (n, 1) distance
    column.  Each round reads its chosen index back to the host, k reads in
    all; the JAX package runs all rounds in one program.  With a ``comm``
    that spans processes (``blocks`` this process's positions' of an
    ``n``-row array) the per-position sums and the last partial sum of each
    position's CDF are gathered and chained in position order, as one
    process chains them, the counts below the draw are summed across the
    processes, and the owner of the chosen row broadcasts it."""
    across = comm is not None and comm.spans_processes
    if not across:
        n = sum(b.shape[0] for b in blocks)
    first = min(int((us[0] * n).to(torch.int64)), n - 1)
    c0 = _rows(blocks, [first], comm, n)
    centers = [c0[0]]
    d = [_k1.cdist(_k1_input(b), _k1_input(c0), sqrt=True)[:, 0] for b in blocks]
    sizes = _sizes(comm, n) if across else [b.shape[0] for b in blocks]
    for j in range(1, k):
        # position of us[j] in cumsum(d / total) over the concatenated blocks:
        # per-block cumsums shifted by the mass of the blocks before them.
        # The CDF is summed in float64: in float32 a point's share (~1/n) is
        # about one ulp of the running sum at n ~ 1e7, so the sum drifts far
        # from the CDF, and the card's scan, whose order of partial sums
        # varies between runs, would pick another point on every run.
        sums = [di.sum(dtype=torch.float64) for di in d]
        if across:
            sums = list(collectives.all_gather([v.reshape(1) for v in sums], comm=comm,
                                               lengths=[1] * comm.size)[0].unbind(0))
        total = collectives.psum(sums)[0]
        u = us[j : j + 1].to(torch.float64)
        cums = [torch.cumsum(di.to(torch.float64) / total, dim=0) for di in d]
        offsets = []
        if across:
            # every position's last partial sum, chained in position order
            lasts = collectives.all_gather([c[-1:] for c in cums], comm=comm,
                                           lengths=[min(m, 1) for m in sizes])[0]
            offset, at, by_pos = torch.zeros((), dtype=torch.float64, device=us.device), 0, []
            for m in sizes:
                by_pos.append(offset)
                if m:
                    offset = lasts[at] + offset
                    at += 1
            offsets = [by_pos[r] for r in comm.local_positions]
        below = torch.zeros((), dtype=torch.int64, device=us.device)
        offset = torch.zeros((), dtype=torch.float64, device=us.device)
        for i, cs in enumerate(cums):
            cum = cs + (offsets[i] if across else offset)
            below = below + torch.searchsorted(cum, u)[0]
            if cum.numel():
                offset = cum[-1]
        if across:
            below = collectives.psum([below], comm=comm)[0]
        nxt = min(int(below), n - 1)
        cj = _rows(blocks, [nxt], comm, n)
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


def _counts(labels: List[torch.Tensor], k: int, comm=None) -> torch.Tensor:
    """Rows a cluster, summed over the positions (int64, (k,)); across the
    processes of ``comm`` when given."""
    return collectives.psum([torch.bincount(lab, minlength=k) for lab in labels], comm=comm)[0]


def _across(comm) -> bool:
    return comm is not None and comm.spans_processes


def _per_process(t: torch.Tensor, comm, rows: List[int]) -> torch.Tensor:
    """Every process's ``t`` (``rows[q]`` rows along dim 0 from the comm's
    process q), concatenated in process order on every process: one
    gather, each process's block riding on its first position."""
    local = comm.local_positions
    firsts = {comm.positions_of(q)[0]: q for q in range(comm.nprocs)}
    lengths = [rows[firsts[r]] if r in firsts else 0 for r in range(comm.size)]
    return collectives.all_gather([t] + [t[:0]] * (len(local) - 1), comm=comm, lengths=lengths)[0]


def _masked_medians(blocks: List[torch.Tensor], labels: List[torch.Tensor], k: int, fallback: torch.Tensor,
                    counts: Optional[List[int]] = None, comm=None) -> torch.Tensor:
    """Per-cluster, per-feature median of the rows assigned to each cluster
    (heat_tpu's ``_masked_medians`` :26): the values at positions
    (cnt − 1)//2 and cnt//2 of the cluster's sorted column, averaged as
    ``(lo + hi) * 0.5`` in the rows' type; ``fallback[j]`` for an empty
    cluster.  The rows of all positions are grouped by label once; each
    cluster's order statistics are then selected from its (f, cnt) copy.
    ``counts`` (host ints) are read from the labels when not given.

    With a ``comm`` that spans processes (``blocks`` this process's) cluster
    j is selected in the comm's process ``j % nprocs``: one gather of the
    per-position counts, then one exchange moves each cluster's rows there
    (an all-to-all by label), and one gather brings every cluster's median
    back to every process.  No process holds more than its clusters' rows;
    the selection is exact, so the medians are one process's bit for bit."""
    dev = blocks[0].device
    x = torch.cat([b.to(dev) for b in blocks]) if len(blocks) > 1 else blocks[0]
    lab = torch.cat([b.to(dev) for b in labels]) if len(labels) > 1 else labels[0]
    if not _across(comm):
        if counts is None:
            counts = torch.bincount(lab, minlength=k).tolist()
        grouped = x[torch.argsort(lab)]
        segs = {}
        start = 0
        for j, cnt in enumerate(counts):
            segs[j] = grouped[start : start + cnt]
            start += cnt
        return _select_medians(segs, k, fallback, x.dtype, dev)
    n_p, me = comm.nprocs, comm.rank
    local = comm.local_positions
    mine = torch.bincount(lab, minlength=k)
    table = _per_process(mine.reshape(1, k), comm, [1] * n_p)
    table = table.tolist()  # ht: HT002 ok — each process's cluster counts size the rows that cross
    grouped = x[torch.argsort(lab, stable=True)]
    starts = [sum(table[me][:j]) for j in range(k)]
    firsts = [comm.positions_of(q)[0] for q in range(n_p)]
    sends, specs = {}, {}
    for j in range(k):
        q = j % n_p
        if q != me and table[me][j]:
            sends[(local[0], firsts[q], j)] = grouped[starts[j]: starts[j] + table[me][j]]
        if q == me:
            for p in range(n_p):
                if p != me and table[p][j]:
                    specs[(firsts[p], local[0], j)] = ((table[p][j], x.shape[1]), x.dtype)
    got = collectives.exchange(sends, specs, comm, dev)
    segs = {}
    for j in range(k):
        if j % n_p != me:
            continue
        pieces = [grouped[starts[j]: starts[j] + table[me][j]] if p == me else got.get((firsts[p], local[0], j))
                  for p in range(n_p)]
        pieces = [t for t in pieces if t is not None and t.shape[0]]
        segs[j] = torch.cat(pieces) if pieces else grouped[:0]
    own = _select_medians(segs, k, fallback, x.dtype, dev)[[j for j in range(k) if j % n_p == me]]
    rows = _per_process(own, comm, [len(range(p, k, n_p)) for p in range(n_p)])
    order = [j for p in range(n_p) for j in range(p, k, n_p)]
    meds = torch.empty_like(rows)
    meds[torch.tensor(order, dtype=torch.int64, device=rows.device)] = rows
    return meds


def _select_medians(segs: dict, k: int, fallback: torch.Tensor, dtype, dev) -> torch.Tensor:
    """The (k, f) medians of the clusters' rows ``segs`` (cluster → its
    rows; a missing or empty cluster keeps ``fallback``'s row)."""
    meds = fallback.to(device=dev, dtype=dtype).clone()
    for j, seg in segs.items():
        cnt = seg.shape[0]
        if cnt:
            seg = seg.T.contiguous()
            lo = torch.kthvalue(seg, (cnt - 1) // 2 + 1, dim=1).values
            hi = lo if cnt % 2 else torch.kthvalue(seg, cnt // 2 + 1, dim=1).values
            meds[j] = (lo + hi) * 0.5
    return meds


def _snap(blocks: List[torch.Tensor], medians: torch.Tensor, counts: torch.Tensor,
          old: torch.Tensor, comm=None) -> torch.Tensor:
    """Each median moved to its nearest sample (heat_tpu's KMedoids step
    :114-118): K1's squared distances of every position's rows to the
    medians (one launch a position), the first nearest row over the
    positions (F1's rule: strictly nearer replaces, so a tie keeps the
    earlier row), taken on the device; an empty cluster keeps ``old``.
    With a ``comm`` that spans processes each process's nearest rows over
    its blocks are gathered and combined in position order by the same
    rule, so the lowest global row wins a tie, as in one process."""

    def better(v, best_v):
        return (v < best_v) | (torch.isnan(v) & ~torch.isnan(best_v))

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
            take = better(v, best_v)
            best_v = torch.where(take, v, best_v)
            best_row = torch.where(take[:, None], row, best_row)
    if _across(comm):
        # one candidate a process with rows, gathered in position order
        flag = torch.tensor([0 if best_v is None else 1], device=blocks[0].device)
        has = _per_process(flag, comm, [1] * comm.nprocs)
        has = has.tolist()  # ht: HT002 ok — which processes hold rows sizes the gather
        k, f = medians.shape
        mine_v = torch.zeros((0, k), dtype=torch.float32, device=blocks[0].device) if best_v is None else best_v[None]
        mine_r = blocks[0].new_zeros((0, k, f)) if best_row is None else best_row[None]
        vs, rs = _per_process(mine_v, comm, has), _per_process(mine_r, comm, has)
        best_v = best_row = None
        for v, row in zip(vs.unbind(0), rs.unbind(0)):
            if best_v is None:
                best_v, best_row = v, row
            else:
                take = better(v, best_v)
                best_v = torch.where(take, v, best_v)
                best_row = torch.where(take[:, None], row, best_row)
    dev = best_row.device
    return torch.where(counts.to(dev)[:, None] > 0, best_row, old.to(device=dev, dtype=best_row.dtype))


def _median_loop(blocks: List[torch.Tensor], centers: torch.Tensor, k: int, max_iter: int, tol: float,
                 snap_to_sample: bool, comm=None):
    """KMedians (KMedoids with ``snap_to_sample``) iterations
    (heat_tpu's ``_median_loop`` :97) while ``it < max_iter`` and
    ``shift > tol``, from ``shift = inf`` (``tol=-1`` runs exactly
    ``max_iter`` steps, KMedoids' ``tol=0`` stops when the medoids stop
    moving).  ``shift = Σ(new − centers)²`` in the data's type.  Returns
    (centers, shift, n_iter).  ``comm``: the processes the blocks are
    spread over (None: the blocks hold every row)."""
    dev = centers.device
    shift = torch.tensor(float("inf"), dtype=centers.dtype, device=dev)
    it = 0
    while it < max_iter:
        labels = [_l1_assign(b, centers.to(b.device)) for b in blocks]
        counts = _counts(labels, k, comm).to(dev)
        # the one read of the iteration: the last shift's test and the counts
        flags = torch.cat([(shift > tol).to(torch.int64)[None], counts]).tolist()
        if not flags[0]:
            break
        new = _masked_medians(blocks, labels, k, centers, counts=flags[1:], comm=comm).to(dev)
        if snap_to_sample:
            new = _snap(blocks, new, counts, centers, comm)
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
                           seed_blocks: Optional[List[torch.Tensor]] = None, rows_comm: bool = False) -> torch.Tensor:
        """Initial centroids (heat_tpu/cluster/_kcluster.py:168) of the n rows
        of width f held in ``blocks``: explicit ones as given, "random" one
        row per stratum [i*n/k, (i+1)*n/k), kmeans++ over ``seed_blocks``
        (default: all the rows).  ``rows_comm``: the blocks are this
        process's positions' of rows spread over ``comm``'s processes."""
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
        # uniforms stay float32 whatever the data dtype; replicated, so every
        # process draws the same stream
        us = ht_random.rand(k, device=device, comm=comm).larray
        spread = comm if rows_comm else None
        if self.init == "random":
            lo = torch.arange(k, device=us.device) * (n // k)
            idx = torch.clamp(lo + (us * max(n // k, 1)).to(torch.int64), max=n - 1)
            return _rows(blocks, idx.tolist(), spread, n)  # ht: HT002 ok — k indices, read once at init
        return _kmeanspp_init(blocks if seed_blocks is None else seed_blocks, us, k, spread, n)

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Initial centroids of the rows of ``x``, replicated."""
        # explicit centroids need only the rows' device: no resplit for them
        blocks = x.comm.local_shards(x.shards)[:1] if isinstance(self.init, DNDarray) else _row_blocks(x)
        centroids = self._initial_centroids(blocks, x.shape[0], x.shape[1], x.device, x.comm,
                                            rows_comm=x.split is not None and x.comm.spans_processes)
        self._cluster_centers = DNDarray(
            [centroids] * x.comm.size, tuple(centroids.shape),
            types.canonical_heat_type(centroids.dtype), None, x.device, x.comm,
        )

    def _assign_to_cluster(self, x: DNDarray, return_inertia: bool = False):
        """Index of the closest centroid for each sample, as an (n, 1) array
        split like ``x`` (heat_tpu/cluster/_kcluster.py:219); with
        ``return_inertia`` also the sum of the row minima of the metric,
        read back once.  Under fusion the distances, the labels and the
        inertia form one program of two roots: the distances (K1 for
        KMeans) are computed once for both.  The labels come back
        materialized."""
        with fusion.sealed():
            distances = self._metric(x, self._cluster_centers)
            labels = statistics.argmin(distances, axis=1, keepdims=True)
            if return_inertia:
                total = statistics.min(distances, axis=1).sum()
                fusion.materialize(labels, total)
                inertia = float(total.item())
            else:
                fusion.materialize(labels)
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
        centers, _, n_iter = _median_loop(blocks, centers, self.n_clusters, self.max_iter, self.tol, snap_to_sample,
                                          _rows_comm(x))
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
        if _rows_comm(x) is not None:
            lab = matching_centroids if matching_centroids.split == 0 else matching_centroids.resplit(0)
            labels = [t.reshape(-1).to(blocks[0].device) for t in x.comm.local_shards(lab.shards)]
        else:
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
        # the labels are read here: the distances' launches belong to predict
        return fusion.materialize(self._assign_to_cluster(x))
