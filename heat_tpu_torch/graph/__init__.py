"""Graph computations (counterpart of heat_tpu/graph/)."""

from .laplacian import Laplacian, laplacian_sparse

__all__ = ["Laplacian", "laplacian_sparse"]
