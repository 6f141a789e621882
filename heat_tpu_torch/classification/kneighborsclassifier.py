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

import torch

from ..core import factories, sanitation, statistics, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray, _wrap
from ..parallel.sort import topk_order, topk_select
from ..spatial import distance

__all__ = ["KNeighborsClassifier"]

# rows of a distance block selected at a time (one host read a block)
_SELECT_ROWS = 4096


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} needs core/quantize.py and core/stream.py, which are not ported yet (ROADMAP queue 1, item 13)"
    )


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
            shards = [(s[:, None] == classes[None, :].to(s.device)).to(torch.float32) for s in y.shards]
            self.y = DNDarray(shards, (y.shape[0], classes.numel()), types.float32, y.split, y.device, y.comm)
        else:
            self.y = y
            self.classes_ = None
        return self

    def quantize_(self, dtype: str = "int8", *, donate: bool = False) -> "KNeighborsClassifier":
        _not_ported("KNeighborsClassifier.quantize_")

    def fit_stream(self, source, y, dataset: Optional[str] = None, *, comm=None, budget=None) -> "KNeighborsClassifier":
        _not_ported("KNeighborsClassifier.fit_stream")

    def close_stream(self) -> None:
        _not_ported("KNeighborsClassifier.close_stream")

    def _predict_stream(self, x: DNDarray) -> DNDarray:
        _not_ported("KNeighborsClassifier._predict_stream")

    def _vote(self, idx: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        """Labels from the neighbours' indices: the most votes, the lower
        class on a tie."""
        winner = torch.argmax(onehot[idx].sum(dim=1), dim=1)
        return winner if self.classes_ is None else self.classes_.shards[0].to(winner.device)[winner]

    def _nearest(self, d: torch.Tensor) -> torch.Tensor:
        k = self.n_neighbors
        parts = [topk_select(d[lo : lo + _SELECT_ROWS], k, largest=False) for lo in range(0, d.shape[0], _SELECT_ROWS)]
        return torch.cat(parts) if parts else d.new_zeros((0, k), dtype=torch.int64)

    def predict(self, x: DNDarray) -> DNDarray:
        """Majority vote of the ``n_neighbors`` nearest training samples
        (kneighborsclassifier.py:218), split as ``x``."""
        if self.x is None:
            raise RuntimeError("fit the model first")
        d = self.effective_metric_(x, self.x)
        onehot = self.y.larray
        k = self.n_neighbors
        if d.split == 0 and d.comm.size > 1:
            shards = [self._vote(self._nearest(s), onehot.to(s.device)) for s in d.shards]
            return DNDarray(shards, (x.shape[0],), types.canonical_heat_type(shards[0].dtype), 0, x.device, x.comm)
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
