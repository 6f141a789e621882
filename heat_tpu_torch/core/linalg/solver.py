"""Iterative solvers (counterpart of heat_tpu/core/linalg/solver.py): ``cg``
and ``lanczos``.

The JAX package fuses each loop into one XLA program.  Here the Lanczos
recurrence is a Python loop of torch ops that reads nothing back to the
host: the breakdown restart is a ``torch.where``, so the host only enqueues
work.  CG reads its residual norm back once per iteration to decide whether
to stop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import types
from ..dndarray import DNDarray, _wrap

__all__ = ["cg", "lanczos"]


def _inexact(t: torch.Tensor) -> torch.dtype:
    return t.dtype if t.is_floating_point() else torch.float32


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive-definite ``A``: at most
    ``len(b)`` iterations, stopping once ‖r‖² ≤ 1e-20."""
    if A.ndim != 2 or b.ndim != 1 or x0.ndim != 1:
        raise RuntimeError("A needs to be 2-D, b and x0 1-D")
    dtype = types.promote_types(types.promote_types(A.dtype, b.dtype), x0.dtype)
    if not issubclass(dtype, types.floating):
        dtype = types.float32
    tt = dtype.torch_type()
    arr = A.larray.to(tt)
    x = x0.larray.to(device=arr.device, dtype=tt)
    r = b.larray.to(device=arr.device, dtype=tt) - arr @ x
    p = r
    rsold = torch.dot(r, r)
    tol2 = torch.tensor(1e-10, dtype=tt) ** 2
    it = 0
    while it < len(b) and bool(rsold > tol2.to(rsold.device)):
        Ap = arr @ p
        alpha = rsold / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rsnew = torch.dot(r, r)
        p = r + (rsnew / rsold) * p
        rsold = rsnew
        it += 1
    result = _wrap(x, b.split, b.device, b.comm)
    if out is not None:
        from .. import sanitation

        return sanitation.sanitize_out(out, result)
    return result


def _dense_apply(operands, v: torch.Tensor) -> torch.Tensor:
    """The dense operator: ``operands`` is the 1-tuple ``(A,)``."""
    return operands[0] @ v


def _lanczos_loop(operands, v: torch.Tensor, m: int, apply_fn):
    """Three-term Lanczos recurrence with full reorthogonalisation against
    the basis, held as an (m, n) row stack.  Returns (V (n, m), alphas (m,),
    betas (m−1,))."""
    n = v.shape[0]
    dtype, dev = v.dtype, v.device
    V = torch.zeros((m, n), dtype=dtype, device=dev)
    alphas = torch.zeros((m,), dtype=dtype, device=dev)
    betas = torch.zeros((max(m - 1, 1),), dtype=dtype, device=dev)
    restart = torch.full((n,), 1.0 / n**0.5, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    w = apply_fn(operands, v)
    a0 = torch.dot(w, v)
    V[0] = v
    alphas[0] = a0
    w = w - a0 * v
    for i in range(1, m):
        beta = torch.linalg.vector_norm(w)
        breakdown = beta < 1e-10
        # happy breakdown: restart from a fixed vector; the
        # reorthogonalisation below projects out the basis either way
        cand = torch.where(breakdown, restart, w / torch.clamp(beta, min=1e-30))
        cand = cand - V[:i].T @ (V[:i] @ cand)
        v_next = cand / torch.clamp(torch.linalg.vector_norm(cand), min=1e-30)
        w = apply_fn(operands, v_next)
        alpha = torch.dot(w, v_next)
        w = w - alpha * v_next - torch.where(breakdown, zero, beta) * V[i - 1]
        V[i] = v_next
        alphas[i] = alpha
        betas[i - 1] = beta
    return V.T, alphas, betas[: m - 1]


def lanczos(
    A,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalisation A ≈ V T Vᵀ with V (n, m) orthonormal and T
    (m, m) tridiagonal.

    ``A`` is a dense square DNDarray or a ``sparse.DCSR_matrix``; a sparse
    operand runs every product through ``sparse.matmul.matvec_program`` (K6
    for float32 values) and is never densified.  Without ``v0`` the start
    vector is uniform random."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError(f"A needs to be a square matrix, got {A.shape}")
    n = A.shape[0]
    m = int(m)
    from ...sparse.dcsr_matrix import DCSR_matrix

    if isinstance(A, DCSR_matrix):
        from ...sparse.matmul import matvec_program

        dtype = A.dtype.torch_type() if issubclass(A.dtype, types.floating) else torch.float32
        apply_fn, operands = matvec_program(A)
    else:
        arr = A.larray
        arr = arr.to(_inexact(arr))
        dtype = arr.dtype
        apply_fn, operands = _dense_apply, (arr,)
    tdev = A.device.torch_device

    if v0 is None:
        from .. import random as ht_random

        v = ht_random.rand(n, device=A.device, comm=A.comm).larray.to(dtype)
    else:
        v = v0.larray.to(device=tdev, dtype=dtype)
    v = v / torch.linalg.vector_norm(v)

    Vm, alphas, betas = _lanczos_loop(operands, v, m, apply_fn)
    T = torch.diag(alphas)
    if m > 1:
        T = T + torch.diag(betas, 1) + torch.diag(betas, -1)
    V_ht = _wrap(Vm, A.split, A.device, A.comm)
    T_ht = _wrap(T, None, A.device, A.comm)
    if V_out is not None and T_out is not None:
        from .. import sanitation

        return sanitation.sanitize_out(V_out, V_ht), sanitation.sanitize_out(T_out, T_ht)
    return V_ht, T_ht
