"""One coordinate-descent sweep of the Lasso, K5 of the port (counterpart of
heat_tpu/ops/lasso_sweep.py, whose Pallas kernel ``_sweep_kernel`` this
replaces).

:func:`sweep` launches the hand-written cooperative CUDA kernel in
``csrc/lasso_sweep.cu`` for tensors on the card; for tensors on the CPU it
computes :func:`reference_sweep`, the classic ``_cd_sweep``
(heat_tpu/regression/lasso.py:25-49) in plain torch ops.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.

Both take the design matrix transposed, ``xt = Xᵀ`` of shape (n, m), made
once per fit by the caller, so that each coordinate's column is one
contiguous stretch.  Coordinate 0 (the intercept) is not penalised.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["reference_sweep", "sweep"]

#: launches so far; :func:`sweep` adds one per sweep it runs on the card,
#: and nowhere else
launches = 0

_SOURCES = ("lasso_sweep.cu",)
_MAX_BLOCKS = 1024
# the kernel's scratch: 2 slots of b + b(b-1)/2 partial sums per CTA, for
# coordinate blocks of b <= 16 (the kernel's b is 8; scripts/probe_k7_k5.py
# builds variants up to 16, and one that keeps a set of sums after them)
_WORK_FLOATS = 2 * (16 + 16 * 15 // 2) * (_MAX_BLOCKS + 1)
_fn = None


def _residual(xt: torch.Tensor, y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """r₀ = y − Xθ, as the JAX sweep starts from it (a GEMV over Xᵀ)."""
    return y - torch.matmul(theta, xt)


def reference_sweep(xt: torch.Tensor, y: torch.Tensor, theta: torch.Tensor, lam: float) -> torch.Tensor:
    """The plain version: one sweep over all n coordinates in order;
    returns the new θ (n,)."""
    m = xt.shape[1]
    r = _residual(xt, y, theta)
    th = theta.clone()
    for j in range(xt.shape[0]):
        xj = xt[j]
        old = th[j].clone()
        rho = torch.dot(xj, r + old * xj) / m
        new = rho if j == 0 else torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)
        r = r + (old - new) * xj
        th[j] = new
    return th


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_lasso_sweep", _SOURCES).heat_lasso_sweep_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def sweep(xt: torch.Tensor, y: torch.Tensor, theta: torch.Tensor, lam: float) -> torch.Tensor:
    """One sweep over the coordinates of ``theta`` (n,) for the design
    matrix given as ``xt = Xᵀ`` (n, m) and targets ``y`` (m,).

    On the card, every operand must be contiguous f32 on one device."""
    global launches
    if xt.ndim != 2 or y.ndim != 1 or theta.ndim != 1:
        raise ValueError("sweep takes xt (n, m), y (m,) and theta (n,)")
    n, m = xt.shape
    if y.shape[0] != m or theta.shape[0] != n:
        raise ValueError(f"shapes differ: xt {tuple(xt.shape)}, y {tuple(y.shape)}, theta {tuple(theta.shape)}")
    if xt.device.type == "cpu" and y.device.type == "cpu" and theta.device.type == "cpu":
        return reference_sweep(xt, y, theta, lam)
    if xt.device.type != "cuda" or y.device != xt.device or theta.device != xt.device:
        raise ValueError(f"sweep needs its operands on one CUDA device, got {xt.device}, {y.device}, {theta.device}")
    if xt.dtype != torch.float32 or y.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError(f"the lasso_sweep kernel takes float32, got {xt.dtype}, {y.dtype}, {theta.dtype}")
    if not (xt.is_contiguous() and y.is_contiguous() and theta.is_contiguous()):
        raise ValueError("the lasso_sweep kernel takes contiguous operands")
    if m < 1 or n < 1 or n >= 2**31:
        raise ValueError(f"the lasso_sweep kernel takes m, n >= 1, got ({m}, {n})")
    r = _residual(xt, y, theta).contiguous()
    out = torch.empty_like(theta)
    work = torch.empty(_WORK_FLOATS, dtype=torch.float32, device=xt.device)
    arrived = torch.zeros(1, dtype=torch.int32, device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        err = _kernel()(
            xt.data_ptr(), r.data_ptr(), theta.data_ptr(), out.data_ptr(), work.data_ptr(),
            arrived.data_ptr(), _WORK_FLOATS, m, n, float(lam), stream,
        )
    if err != 0:
        raise RuntimeError(f"lasso_sweep kernel launch failed with cudaError_t {err}")
    launches += 1
    return out
