"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

Ported so far: K1, the fused squared-distance kernel (:mod:`.cdist`); K4,
the fused CholeskyQR panel pass (:mod:`.qr_panel`); K5, the Lasso
coordinate-descent sweep (:mod:`.lasso_sweep`); K6, the ELL sparse
matrix-vector product (:mod:`.spmv`).
"""

from . import cdist, lasso_sweep, qr_panel, spmv

__all__ = ["cdist", "lasso_sweep", "qr_panel", "spmv"]
