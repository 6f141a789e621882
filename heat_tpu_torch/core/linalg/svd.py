"""Singular value decomposition (counterpart of heat_tpu/core/linalg/svd.py).

Two routes, as in the JAX package.  A tall-skinny matrix split along its
rows over several positions (``m >= n * positions``) factors by TSQR through
:func:`qr` (``A = Q R``), then takes the small SVD of R (``R = U' S Vᵀ``)
and ``U = Q U'`` by :func:`matmul`, so U keeps the row split.  Every other
matrix takes ``torch.linalg.svd`` of the global array (float32 factored
in float64; on the card by cuSOLVER's gesvd).  S and V are replicated;
V is returned, not Vᵀ.
"""

from __future__ import annotations

import collections

import torch

from .. import sanitation
from ..dndarray import DNDarray, _wrap
from .basics import _factor_input, matmul
from .qr import qr

__all__ = ["svd"]

SVD = collections.namedtuple("SVD", "U, S, V")


def _svd(t: torch.Tensor):
    """Thin ``torch.linalg.svd``, float32 factored in float64 and rounded
    back on either device; on the card by cuSOLVER's QR-based gesvd.  In
    float32 cuSOLVER's gesvd leaves the singular values of a 2048^2
    Gaussian matrix 1.9e-5 of the largest off (LAPACK's gesdd on the host:
    6.4e-6), and torch's default there, the Jacobi gesvdj, 3e-4."""
    wide = t.dtype == torch.float32
    u, s, vh = torch.linalg.svd(t.double() if wide else t, full_matrices=False,
                                driver="gesvd" if t.is_cuda else None)
    return (u.float(), s.float(), vh.float()) if wide else (u, s, vh)


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Thin SVD ``a = U @ diag(S) @ V.T`` (heat_tpu/core/linalg/svd.py:25):
    ``SVD(U, S, V)``, or S alone with ``compute_uv=False``.
    ``full_matrices=True`` raises."""
    sanitation.sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"svd requires a 2-D array, got {a.ndim}-D")
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported (thin SVD only)")
    m, n = a.shape
    if a.split == 0 and m >= n * a.comm.size and a.comm.size > 1:
        _factor_input(a.shards[0])
        q, r = qr(a, calc_q=compute_uv)
        u_small, s, vt = _svd(r.shards[0])
        S = _wrap(s, None, a.device, a.comm)
        if not compute_uv:
            return S
        U = matmul(q, _wrap(u_small, None, a.device, a.comm))
        return SVD(U, S, _wrap(vt.T.contiguous(), None, a.device, a.comm))
    u, s, vt = _svd(_factor_input(a.larray))
    S = _wrap(s, None, a.device, a.comm)
    if not compute_uv:
        return S
    return SVD(_wrap(u, a.split, a.device, a.comm), S, _wrap(vt.T.contiguous(), None, a.device, a.comm))
