"""A fitted KMeans from fitted state given as numpy arrays, e.g. that of a
heat_tpu KMeans: ``cluster_centers_``, ``n_iter_``, ``inertia_`` and
``n_clusters``.  The model then predicts as the one it came from."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import factories
from .kmeans import KMeans

__all__ = ["kmeans_from_state"]


def kmeans_from_state(
    cluster_centers,
    n_iter: int,
    inertia: float,
    n_clusters: Optional[int] = None,
    device=None,
    comm=None,
) -> KMeans:
    """A fitted :class:`KMeans` holding ``cluster_centers`` (k, f) on
    ``device``, replicated over ``comm``; ``labels_`` stays None."""
    centers = np.asarray(cluster_centers)
    if centers.ndim != 2:
        raise ValueError(f"cluster_centers must be 2-D, got shape {centers.shape}")
    k = centers.shape[0]
    if n_clusters is not None and int(n_clusters) != k:
        raise ValueError(f"n_clusters={n_clusters} does not match {k} cluster centers")
    model = KMeans(n_clusters=k)
    model._cluster_centers = factories.array(centers, device=device, comm=comm)
    model._n_iter = int(n_iter)
    model._inertia = float(inertia)
    return model
