"""Fused CholeskyQR panel pass, K4 of the port (counterpart of
heat_tpu/ops/qr_panel.py, whose Pallas kernel ``_panel_kernel`` this
replaces).

:func:`fused_gram_chol` launches the hand-written CUDA kernels in
``csrc/qr_panel.cu`` for a tensor on the card; for a tensor on the CPU it
computes :func:`reference_fused_gram_chol`, the classic chain of
heat_tpu/core/linalg/qr.py:159-172, :183 (Gram, Cholesky, triangular solve)
in plain torch ops.  There is no fallback between the two: a CUDA tensor the
kernel does not take raises.

Both NaN-latch a failed factorisation as ``jnp.linalg.cholesky`` does: for
a Gram matrix that is not positive definite, R is NaN on and above its
diagonal (and 0 below) and R⁻¹ is NaN throughout.  ``torch.linalg.cholesky``
raises on such a matrix instead, so the plain version uses ``cholesky_ex``
and turns ``info != 0`` into NaN.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["cholesky_nan", "fused_gram_chol", "reference_fused_gram_chol"]

#: launches so far; :func:`fused_gram_chol` adds one per panel pass it runs
#: on the card, and nowhere else
launches = 0

_SOURCES = ("qr_panel.cu",)
_fns = None


def cholesky_nan(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``g``; where ``g`` is not positive definite,
    NaN on and below the diagonal (``jnp.linalg.cholesky``'s contract).
    No host sync."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info[..., None, None] == 0, l, torch.tril(torch.full_like(l, float("nan"))))


def reference_fused_gram_chol(x: torch.Tensor):
    """The plain version: ``(r, rinv)`` with ``r = chol(xᵀx)ᵀ`` and
    ``rinv = r⁻¹``, both (n, n), in ``x``'s dtype."""
    l = cholesky_nan(x.T @ x)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    rinv = torch.linalg.solve_triangular(l, eye, upper=False).T
    return l.T, rinv


def _kernel():
    global _fns
    if _fns is None:
        from ._build import load

        lib = load("heat_qr_panel", _SOURCES)
        size = lib.heat_qr_panel_workspace_f32
        size.argtypes = [ctypes.c_longlong, ctypes.c_int]
        size.restype = ctypes.c_longlong
        run = lib.heat_qr_panel_f32
        run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        run.restype = ctypes.c_int
        _fns = (size, run)
    return _fns


def fused_gram_chol(x: torch.Tensor):
    """One panel pass over ``x`` (m, n), m ≥ n ≥ 2: ``(r, rinv)`` with
    ``r = chol(xᵀx)ᵀ`` and ``rinv = r⁻¹``, both (n, n).

    On the card, ``x`` must be contiguous row-major f32."""
    global launches
    if x.ndim != 2:
        raise ValueError(f"the panel pass takes a 2-D panel, got {x.ndim}-D")
    m, n = x.shape
    if x.device.type == "cpu":
        return reference_fused_gram_chol(x)
    if x.device.type != "cuda":
        raise ValueError(f"the qr_panel kernel runs on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the qr_panel kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the qr_panel kernel takes a contiguous row-major panel")
    if not m >= n >= 2:
        raise ValueError(f"the qr_panel kernel takes m >= n >= 2, got ({m}, {n})")
    size, run = _kernel()
    r = torch.empty((n, n), dtype=torch.float32, device=x.device)
    rinv = torch.empty_like(r)
    work = torch.empty(int(size(m, n)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = run(x.data_ptr(), r.data_ptr(), rinv.data_ptr(), work.data_ptr(), m, n, stream)
    if err != 0:
        raise RuntimeError(f"qr_panel kernel launch failed with cudaError_t {err}")
    launches += 1
    return r, rinv
