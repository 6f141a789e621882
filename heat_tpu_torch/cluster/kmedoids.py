"""K-Medoids clustering (counterpart of heat_tpu/cluster/kmedoids.py): the
new centre of a cluster is the sample nearest to the median of its rows
(found through K1), and the fit stops when the medoids stop moving
(``tol`` = 0)."""

from __future__ import annotations

from typing import Optional, Union

from ..core import types
from ..core.dndarray import DNDarray
from ..spatial import distance
from . import _kcluster
from ._kcluster import _KCluster

__all__ = ["KMedoids"]


class KMedoids(_KCluster):
    """K-Medoids: L1 assignment, centres snapped to samples.  ``init`` is
    "random", "kmedoids++" (distance-weighted seeding, "probability_based")
    or explicit centroids."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedoids++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.manhattan(x, y, expand=True),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=0.0,
            random_state=random_state,
        )

    def _update_centroids(self, x: DNDarray, matching_centroids: DNDarray) -> DNDarray:
        """Medians from given labels, each snapped to its nearest sample
        (heat_tpu/cluster/kmedoids.py:46)."""
        blocks, labels, old = self._label_blocks(x, matching_centroids)
        comm = _kcluster._rows_comm(x)
        med = _kcluster._masked_medians(blocks, labels, self.n_clusters, old, comm=comm)
        new = _kcluster._snap(blocks, med, _kcluster._counts(labels, self.n_clusters, comm), old, comm)
        return DNDarray(
            [new] * x.comm.size, tuple(new.shape), types.canonical_heat_type(new.dtype), None, x.device, x.comm,
        )

    def fit(self, x: DNDarray) -> "KMedoids":
        """Iterate until the medoids stop moving, or ``max_iter``."""
        return self._fit_median_loop(x, snap_to_sample=True)
