"""K-Medians clustering (counterpart of heat_tpu/cluster/kmedians.py): the
Manhattan metric and the per-cluster median update of
:func:`~heat_tpu_torch.cluster._kcluster._median_loop`."""

from __future__ import annotations

from typing import Optional, Union

from ..core import types
from ..core.dndarray import DNDarray
from ..spatial import distance
from . import _kcluster
from ._kcluster import _KCluster

__all__ = ["KMedians"]


class KMedians(_KCluster):
    """K-Medians: L1 assignment, centres moved to the per-feature medians
    of their clusters.  ``init`` is "random", "kmedians++" (distance-weighted
    seeding, "probability_based") or explicit centroids."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedians++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.manhattan(x, y, expand=True),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def _update_centroids(self, x: DNDarray, matching_centroids: DNDarray) -> DNDarray:
        """Per-cluster medians from given labels (heat_tpu/cluster/kmedians.py:47);
        ``fit`` runs the loop."""
        blocks, labels, old = self._label_blocks(x, matching_centroids)
        new = _kcluster._masked_medians(blocks, labels, self.n_clusters, old)
        return DNDarray(
            [new] * x.comm.size, tuple(new.shape), types.canonical_heat_type(new.dtype), None, x.device, x.comm,
        )

    def fit(self, x: DNDarray) -> "KMedians":
        """Assignment and median update until the squared centroid shift is
        at most ``tol``, or ``max_iter``."""
        return self._fit_median_loop(x, snap_to_sample=False)
