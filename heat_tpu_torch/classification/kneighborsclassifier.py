"""k-nearest-neighbours classification (counterpart of
heat_tpu/classification/kneighborsclassifier.py).

``predict`` keeps the JAX package's dataflow: the distance matrix of the
queries to the training set (``spatial.cdist`` by default, so K1 for
float32), the k smallest distances of each query, the sum of those
neighbours' one-hot label rows, and its argmax.  The layout of the
distances decides the top-k:

* row-split (queries split along their rows, as a batch is): each position
  selects the k nearest of its own rows, a block of rows at a time, so
  nothing beside the distance matrix is larger than one block's mask;
* column-split (replicated queries against a split training set, as a
  served request is): each position selects its k candidates with global
  indices, and the candidates are merged as :func:`manipulations.mpi_topk`
  merges partial top-k results;
* replicated: one selection.

Ties break as ``lax.top_k`` and ``argmax`` break them in the JAX package:
among equal distances the lower training index, among equal votes the
lower class (``parallel.sort.topk_select``, ``topk_order``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import factories, fusion, sanitation, statistics, telemetry, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray, _wrap
from ..parallel.sort import topk_order, topk_select
from ..spatial import distance

__all__ = ["KNeighborsClassifier"]

# rows of a distance block selected at a time (one host read a block)
_SELECT_ROWS = 4096


class KNeighborsClassifier(ClassificationMixin, BaseEstimator):
    """k-nearest-neighbours classifier
    (heat_tpu/classification/kneighborsclassifier.py:23).

    Parameters
    ----------
    n_neighbors : int
        Neighbours that vote.
    effective_metric_ : callable, optional
        ``metric(queries, training_set)`` giving a distance DNDarray;
        :func:`spatial.cdist` by default.
    """

    def __init__(self, n_neighbors: int = 5, effective_metric_: Optional[Callable] = None):
        self.n_neighbors = n_neighbors
        self.effective_metric_ = effective_metric_ if effective_metric_ is not None else distance.cdist
        self.x = None
        self.y = None
        self.classes_ = None
        self._qx = None
        self._stream_src = None
        self._stream_own = False
        self._stream_plan = None
        self._stream_budget = None

    @staticmethod
    def one_hot_encoding(x: DNDarray) -> DNDarray:
        """One-hot float32 rows of a vector (or one column) of class indices,
        as wide as the largest index + 1, split as ``x``
        (kneighborsclassifier.py:42)."""
        labels = x.larray.reshape(-1).to(torch.int64)
        width = int(statistics.max(x).item()) + 1
        encoded = torch.nn.functional.one_hot(labels, width).to(torch.float32)
        return factories.array(encoded, split=x.split, device=x.device, comm=x.comm)

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Keep the training set (kneighborsclassifier.py:53).  1-D labels
        are one-hot encoded against their sorted unique values
        (``classes_``); 2-D labels are taken as one-hot rows."""
        sanitation.sanitize_in(x)
        sanitation.sanitize_in(y)
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"Number of samples x and y samples mismatch: {x.shape[0]} != {y.shape[0]}")
        self.x = x
        if y.ndim == 1:
            classes = torch.unique(y.larray, sorted=True)
            self.classes_ = _wrap(classes, None, y.device, y.comm)
            shards = y.comm.per_position(
                lambda r: (y.shards[r][:, None] == classes[None, :].to(y.shards[r].device)).to(torch.float32),
                (y.shape[0], classes.numel()), y.split)
            self.y = DNDarray(shards, (y.shape[0], classes.numel()), types.float32, y.split, y.device, y.comm)
        else:
            self.y = y
            self.classes_ = None
        return self

    def quantize_(self, dtype: str = "int8", *, donate: bool = False) -> "KNeighborsClassifier":
        """Quantize the fitted corpus in place (int8/fp8, absmax scales per
        feature, axis 1 of the (n_train, d) corpus) and drop the
        full-precision master (kneighborsclassifier.py:80): ``predict`` then
        runs through :func:`spatial.cdist_quantized`.  ``donate=True`` also
        tags the master's shards ``donated`` and poisons them for the
        sanitizer."""
        from ..core import quantize

        if self.x is None:
            raise RuntimeError("fit the model first" if self._qx is None else "corpus is already quantized")
        if self.effective_metric_ is not distance.cdist:
            raise ValueError("quantize_ supports the default euclidean metric only")
        self._qx = quantize.quantize_weights(self.x, dtype, axis=1, donate=donate)
        self.x = None  # release the master: the residency win
        return self

    def fit_stream(self, source, y, dataset: Optional[str] = None, *, comm=None, budget=None) -> "KNeighborsClassifier":
        """Fit on a corpus that does not fit on the card
        (heat_tpu/classification/kneighborsclassifier.py:107): keep the
        chunk source's handle, not the data.  ``predict`` then streams the
        corpus past the queries once a call, carrying each query's best k
        (:func:`spatial.distance._stream_topk_merge`, K1's squared
        distances).  ``y`` (class indices, or one-hot rows) stays in memory,
        replicated; :meth:`close_stream` releases the handle."""
        from ..core import devices, stream
        from ..parallel.mesh import sanitize_comm

        comm = sanitize_comm(comm)
        device = devices.sanitize_device(None)
        src = stream.open_source(source, dataset=dataset, np_dtype=np.float32)
        if len(src.shape) != 2:
            raise ValueError(f"corpus needs to be 2-D, but was {len(src.shape)}-D")
        n = src.shape[0]
        y_host = np.asarray(y.numpy() if isinstance(y, DNDarray) else y)
        if y_host.shape[0] != n:
            raise ValueError(f"Number of samples x and y samples mismatch: {n} != {y_host.shape[0]}")
        if y_host.ndim == 1:
            classes = np.unique(y_host)
            self.classes_ = factories.array(classes, split=None, device=device, comm=comm)
            onehot = (y_host[:, None] == classes[None, :]).astype(np.float32)
        else:
            self.classes_ = None
            onehot = y_host.astype(np.float32)
        # replicated: the votes gather rows by global corpus index
        self.y = factories.array(onehot, split=None, device=device, comm=comm)
        self.close_stream()
        self._stream_src = src
        self._stream_own = src is not source
        self._stream_plan = None
        self._stream_budget = budget
        self.x = None
        self._qx = None
        return self

    def close_stream(self) -> None:
        """Release the out-of-core corpus (no-op when not streaming, or when
        the caller owns the :class:`stream.ChunkSource`)."""
        if self._stream_src is not None and self._stream_own:
            self._stream_src.close()
        self._stream_src = None
        self._stream_plan = None

    def _predict_stream(self, x: DNDarray) -> DNDarray:
        """One streaming pass of the corpus past the queries: each slab
        merged into the carried best k (heat_tpu :183)."""
        from ..core import stream

        src = self._stream_src
        if self._stream_plan is None:
            # planned once: every later predict keeps the same slab rows
            self._stream_plan = stream.plan_pass(src, comm=x.comm, site="knn_predict", budget=self._stream_budget)
        pl = self._stream_plan
        q = x.larray
        if not q.is_floating_point():
            q = q.to(torch.float32)
        k = self.n_neighbors
        nq = q.shape[0]
        best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device)
        best_i = torch.zeros((nq, k), dtype=torch.int64, device=q.device)
        sp = stream.StreamPass(src, comm=x.comm, plan=pl)
        for slab in sp:
            best_d, best_i = distance._stream_topk_merge(q, slab.x.larray, slab.valid, slab.base, best_d, best_i, k)
            del slab  # drop the loop reference: the three-slab residency cap
        rep = stream.finish_pass(sp)
        self.last_stream_report = dict(rep, arm=pl.arm, budget=pl.budget)
        n, f = src.shape
        fp = telemetry.fingerprint(("stream_knn", pl.slab_rows, f, k, nq, x.comm.size))
        telemetry.ensure_program(fp, kind="stream_knn", dtype="float32", flops=2.0 * n * f * nq,
                                 hbm_bytes=float(n) * f * 4)
        telemetry.record_timing(fp, rep["wall_s"])
        telemetry.annotate_program(fp, io_stall_frac=round(1.0 - rep["overlap_frac"], 4), io_bytes=rep["bytes_read"])
        labels = self._vote(best_i, self.y.larray.to(best_i.device))
        return _wrap(labels, x.split, x.device, x.comm)

    def _vote(self, idx: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        """Labels from the neighbours' indices: the most votes, the lower
        class on a tie."""
        winner = torch.argmax(onehot[idx].sum(dim=1), dim=1)
        return winner if self.classes_ is None else self.classes_.larray.to(winner.device)[winner]

    def _nearest(self, d: torch.Tensor) -> torch.Tensor:
        k = self.n_neighbors
        parts = [topk_select(d[lo : lo + _SELECT_ROWS], k, largest=False) for lo in range(0, d.shape[0], _SELECT_ROWS)]
        return torch.cat(parts) if parts else d.new_zeros((0, k), dtype=torch.int64)

    def _distances(self, x: DNDarray) -> DNDarray:
        """The queries' distances to the corpus: through the quantized ring
        for a quantized corpus (kneighborsclassifier.py:225-232), and where
        its layout does not fit, through the metric on the corpus
        dequantized for this call."""
        if self._qx is None:
            # materialized here: the timed region holds K1's launches
            with fusion.sealed():
                return fusion.materialize(self.effective_metric_(x, self.x))
        d = distance.cdist_quantized(x, self._qx)
        if d is not None:
            return d
        with fusion.sealed():
            return fusion.materialize(self.effective_metric_(x, self._qx.dequantize()))

    @telemetry.span("knn.predict")
    def predict(self, x: DNDarray) -> DNDarray:
        """Majority vote of the ``n_neighbors`` nearest training samples
        (kneighborsclassifier.py:218), split as ``x``."""
        if self._stream_src is not None:
            return self._predict_stream(x)
        if self.x is None and self._qx is None:
            raise RuntimeError("fit the model first")
        corpus = self.x if self._qx is None else self._qx
        nq, n, f = x.shape[0], corpus.shape[0], corpus.shape[1]
        fp = telemetry.fingerprint(("knn_distances", nq, n, f, str(x.dtype), x.comm.size))
        if self.effective_metric_ is distance.cdist:
            # K1's work: 2·nq·n·f operations; both operands read once, the
            # distances written once
            telemetry.ensure_program(fp, kind="kernel_cdist", ops=1, flops=2.0 * nq * n * f,
                                     hbm_bytes=float((nq + n) * f * x.dtype.torch_type().itemsize + nq * n * 4),
                                     mesh={"devices": x.comm.size}, dtype=str(x.dtype))
        else:
            telemetry.ensure_program(fp, kind="knn_distances", mesh={"devices": x.comm.size}, dtype=str(x.dtype))
        d = telemetry.timed_call(fp, self._distances, x, device=x.device.torch_device)
        onehot = self.y.larray
        k = self.n_neighbors
        if d.split == 0 and d.comm.size > 1:
            # on a comm that spans processes: this process's positions
            shards = d.comm.per_position(lambda r: self._vote(self._nearest(d.shards[r]), onehot.to(d.shards[r].device)),
                                         (x.shape[0],), 0)
            return DNDarray(shards, (x.shape[0],), types.canonical_heat_type(d.comm.local_shards(shards)[0].dtype), 0,
                            x.device, x.comm)
        if d.split == 1 and d.comm.size > 1:
            cand_v, cand_i, off = [], [], 0
            for s in d.shards:
                m = s.shape[1]
                if m:
                    sel = self._nearest(s) if m > k else topk_order(s, m, largest=False)
                    cand_v.append(s.gather(1, sel))
                    cand_i.append(sel + off)
                off += m
            _, idx = _merge_candidates(cand_v, cand_i, k)
            labels = self._vote(idx, onehot.to(idx.device))
        else:
            labels = self._vote(self._nearest(d.shards[0]), onehot.to(d.shards[0].device))
        return _wrap(labels, x.split, x.device, x.comm)


def _merge_candidates(values, indices, k: int):
    """The k smallest of the per-position candidates (each ordered, with
    global indices) concatenated in position order, by ``mpi_topk``'s rule:
    ``lax.top_k``'s order, so a tie keeps the lower index."""
    v, i = torch.cat(values, dim=-1), torch.cat(indices, dim=-1)
    sel = topk_order(v, k, largest=False)
    return v.gather(-1, sel), i.gather(-1, sel)
