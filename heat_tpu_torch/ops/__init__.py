"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

Ported so far: K1, the fused squared-distance kernel (:mod:`.cdist`); K2,
the blocked GEMM (:mod:`.matmul`, exported as :func:`pallas_matmul`); K3,
flash attention (:mod:`.attention`, exported as :func:`flash_attention`);
K4, the fused CholeskyQR panel pass (:mod:`.qr_panel`); K5, the Lasso
coordinate-descent sweep (:mod:`.lasso_sweep`); K6, the ELL sparse
matrix-vector product (:mod:`.spmv`); K7, the rechunk repack of the
transport engine (:mod:`.repack`); T1, the Threefry-2x32 random streams
(:mod:`.threefry`, no Pallas counterpart).  :mod:`.halo` is the halo
exchange over the shard list, which needs no kernel.
"""

from . import attention, cdist, halo, lasso_sweep, matmul, qr_panel, repack, spmv, threefry
from .attention import flash_attention
from .matmul import matmul as pallas_matmul

__all__ = ["attention", "cdist", "flash_attention", "halo", "lasso_sweep", "matmul", "pallas_matmul", "qr_panel", "repack", "spmv", "threefry"]
