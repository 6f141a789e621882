"""A fitted Lasso from fitted state given as numpy arrays, e.g. that of a
heat_tpu Lasso: ``theta`` (the intercept, then the coefficients), ``lam``
and ``n_iter``.  The model then predicts as the one it came from."""

from __future__ import annotations

import numpy as np

from ..core import factories
from .lasso import Lasso

__all__ = ["lasso_from_state"]


def lasso_from_state(
    theta, lam: float, n_iter: int, max_iter: int = 100, tol: float = 1e-6, device=None, comm=None
) -> Lasso:
    """A fitted :class:`Lasso` holding ``theta`` ((n+1,) or (n+1, 1)) on
    ``device``, replicated over ``comm``."""
    theta = np.asarray(theta)
    if theta.ndim not in (1, 2) or (theta.ndim == 2 and theta.shape[1] != 1) or theta.shape[0] < 1:
        raise ValueError(f"theta must have shape (n+1,) or (n+1, 1), got {theta.shape}")
    model = Lasso(lam=lam, max_iter=max_iter, tol=tol)
    arr = factories.array(theta.reshape(-1, 1), device=device, comm=comm)
    model._set_theta(arr.larray, arr)
    model.n_iter = int(n_iter)
    return model
