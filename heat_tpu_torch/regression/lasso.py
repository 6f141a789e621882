"""Lasso regression by coordinate descent (counterpart of
heat_tpu/regression/lasso.py).

Fitting augments the design matrix with an unpenalised intercept column and
runs sweeps until ``max|Δθ| < tol`` or ``max_iter``, reading the
convergence flag back once per sweep (the JAX package keeps the loop on the
device).  The augmented matrix is built transposed, ``Xᵀ`` of shape
(n+1, m), once per fit: each coordinate's column is then one contiguous
stretch for K5 (:mod:`heat_tpu_torch.ops.lasso_sweep`), which runs every
float32 sweep on the card.  Other dtypes take the plain sweep.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import _operations, autotune, sanitation, telemetry, types
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray, _wrap
from ..ops import lasso_sweep

__all__ = ["Lasso"]


def _float(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.float32)


def _augmented_t(x: torch.Tensor) -> torch.Tensor:
    """``[1, x]ᵀ``: the intercept row, then ``xᵀ``, contiguous (n+1, m)."""
    m, n = x.shape
    xt = torch.empty((n + 1, m), dtype=x.dtype, device=x.device)
    xt[0] = 1
    xt[1:].copy_(x.T)
    return xt


def _cd_fit(xt: torch.Tensor, y: torch.Tensor, theta: torch.Tensor, lam: float, max_iter: int, tol: float):
    """Sweeps until ``max|Δθ| < tol`` or ``max_iter``
    (heat_tpu/regression/lasso.py:53).  Returns ``(theta, diff, n_iter)``."""
    na, ma = xt.shape
    dt = str(xt.dtype)
    if xt.dtype == torch.float32 and na >= 2:
        sweep = lasso_sweep.sweep
        fp = telemetry.fingerprint(("lasso_sweep", ma, na, dt))
        # K5's work a sweep: four operations an element of X, read once
        telemetry.ensure_program(fp, kind="kernel_lasso_sweep", ops=1, flops=4.0 * ma * na,
                                 hbm_bytes=float(ma * na * xt.element_size()), dtype=dt)
    else:
        sweep = lasso_sweep.reference_sweep
        fp = telemetry.fingerprint(("lasso_sweep_plain", ma, na, dt))
        telemetry.ensure_program(fp, kind="lasso_sweep", ops=1, dtype=dt)
    diff = torch.tensor(float("inf"), dtype=xt.dtype, device=xt.device)
    it = 0
    # diff >= tol compares in the data's dtype, as the JAX loop's carry does
    while it < max_iter and bool(diff >= tol):
        new = telemetry.timed_call(fp, sweep, xt, y, theta, lam, device=xt.device)
        diff = torch.max(torch.abs(new - theta))
        theta = new
        it += 1
    return theta, diff, it


class Lasso(RegressionMixin, BaseEstimator):
    """L1-regularised least squares by coordinate descent
    (heat_tpu/regression/lasso.py:84).  ``lam`` is the regularisation
    strength; the intercept is fitted unpenalised."""

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        """Feature coefficients (without the intercept), (n, 1)."""
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def lam(self) -> float:
        return self.__lam

    @lam.setter
    def lam(self, arg: float):
        self.__lam = arg

    @property
    def theta(self) -> Optional[DNDarray]:
        """Intercept and coefficients, (n+1, 1), replicated."""
        return self.__theta

    def _set_theta(self, theta: torch.Tensor, like: DNDarray) -> None:
        self.__theta = _wrap(theta.reshape(-1, 1), None, like.device, like.comm)

    def soft_threshold(self, rho: DNDarray) -> DNDarray:
        """Soft threshold ``sign(rho)·max(|rho| − lam, 0)``."""
        lam = self.__lam
        return _operations._local_op(
            lambda t: torch.sign(t) * torch.clamp(torch.abs(t) - lam, min=0.0), rho, no_cast=True
        )

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root mean squared error."""
        g, e = gt.larray, yest.larray
        return float(torch.sqrt(torch.mean((g - e.to(g.device)) ** 2)))

    @telemetry.span("lasso.fit")
    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate descent until the largest coefficient change is below
        ``tol``, or ``max_iter`` sweeps."""
        sanitation.sanitize_in(x)
        sanitation.sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2-D, but was {x.ndim}-D")
        X = _float(x.larray)
        yv = y.larray.reshape(-1).to(device=X.device, dtype=X.dtype).contiguous()
        xt = _augmented_t(X)
        theta0 = torch.zeros(xt.shape[0], dtype=X.dtype, device=X.device)
        na, ma = xt.shape
        if xt.dtype == torch.float32 and na >= 2 and autotune.site_tunes(xt):
            # K5's one-arm row under heat_tpu's key (lasso.py:169-184): the
            # kernel sweeps whatever the table holds
            dt = autotune.dtype_name(xt.dtype)
            fp_k = telemetry.fingerprint(("lasso_sweep_fused", ma, na, dt))
            telemetry.ensure_program(fp_k, kind="kernel_lasso_sweep", ops=1, flops=4.0 * ma * na,
                                     hbm_bytes=float(ma * na * xt.element_size()),
                                     mesh={"devices": x.comm.size}, dtype=dt)
            key = autotune.kernel_key("lasso_sweep", ma, na, dt, x.comm.size)
            theta, _, n_iter = autotune.kernel_site(key, f"lasso {ma}x{na} {dt}", _cd_fit, xt, yv, theta0,
                                                    self.__lam, self.max_iter, self.tol, fp=fp_k, device=xt.device)
        else:
            theta, _, n_iter = _cd_fit(xt, yv, theta0, self.__lam, self.max_iter, self.tol)
        self.n_iter = n_iter
        self._set_theta(theta, x)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """ŷ = [1, x]·θ, (m, 1), split 0 when ``x`` is split 0."""
        sanitation.sanitize_in(x)
        if self.__theta is None:
            raise RuntimeError("fit the model first")
        theta = self.__theta.larray.reshape(-1)

        def local(xs: torch.Tensor) -> torch.Tensor:
            xs = _float(xs)
            xa = torch.cat([xs.new_ones((xs.shape[0], 1)), xs], dim=1)
            return torch.matmul(xa, theta.to(device=xs.device, dtype=xs.dtype)).reshape(-1, 1)

        if x.split == 0:
            shards = [local(s) for s in x.shards]
            return DNDarray(
                shards, (x.shape[0], 1), types.canonical_heat_type(shards[0].dtype), 0, x.device, x.comm
            )
        return _wrap(local(x.larray), None, x.device, x.comm)
