"""Fitted estimators from fitted state given as numpy arrays, e.g. that of
a heat_tpu estimator.  A KMeans takes ``cluster_centers_``, ``n_iter_``,
``inertia_`` and ``n_clusters``; a Spectral its parameters and its KMeans's
``cluster_centers_``.  The model then predicts as the one it came from."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import factories
from .kmeans import KMeans

__all__ = ["kmeans_from_state", "spectral_from_state"]


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


def spectral_from_state(params: dict, cluster_centers, device=None, comm=None):
    """A fitted :class:`~heat_tpu_torch.cluster.Spectral` built from a fitted
    heat_tpu Spectral: ``params`` is its ``get_params(deep=False)`` and
    ``cluster_centers`` its KMeans's ``cluster_centers_`` as numpy (k, k),
    the centres in the embedding.  ``predict`` then embeds new data and
    assigns it as the heat_tpu model does; ``labels_`` stays None.  A
    heat_tpu DCSR matrix crosses to the port as ``A.to_scipy()`` into
    ``sparse.sparse_csr_matrix``."""
    from .spectral import Spectral

    centers = np.asarray(cluster_centers)
    kwargs = {k: v for k, v in params.items() if k in Spectral._parameter_names()}
    kwargs["n_clusters"] = centers.shape[0]
    model = Spectral(**kwargs)
    model._cluster = kmeans_from_state(centers, 0, 0.0, n_clusters=centers.shape[0], device=device, comm=comm)
    return model
