"""QR decomposition (counterpart of heat_tpu/core/linalg/qr.py).

Three routes, chosen as in the JAX package:

* **TSQR** (``a.split == 0``, more than one position, ``m ≥ n·positions``):
  each position factors its row block with ``torch.linalg.qr`` (the JAX
  package's local Householder is XLA's geqrf), the R factors are gathered,
  one merge QR gives the global R, signs are normalised so that R has a
  non-negative diagonal, and each position's Q is its local Q times its
  block of the merge Q.
* **CholeskyQR2** (``m ≥ 2n``): ``G = AᵀA; R = chol(G)ᵀ; Q = A·R⁻¹``, twice.
  Each float32 panel pass goes through K4 (:mod:`heat_tpu_torch.ops.qr_panel`),
  which on the card launches the CUDA kernel; ``Q = A·R⁻¹`` stays a
  ``torch.matmul``.  Other dtypes, and the bfloat16-rounded first pass of
  ``precision="mixed"``, take the plain torch chain.
* **Blocked BCGS2** (``n ≤ m < 2n``): split the columns, factor the left
  half recursively, orthogonalise the right half against its Q twice, and
  recurse; every leaf is CholeskyQR2.

A failed Cholesky NaN-latches R; ``check="eager"`` reads one flag back and
falls back to Householder QR, ``check="defer"`` returns the NaNs.
"""

from __future__ import annotations

import collections

import torch

from .. import autotune, sanitation, telemetry, types
from ..dndarray import DNDarray, _wrap
from ...ops import qr_panel
from ...parallel import collectives

__all__ = ["orthogonality_defect", "qr"]

QR = collections.namedtuple("QR", "Q, R")


def orthogonality_defect(q: DNDarray) -> DNDarray:
    """``max|QᵀQ − I|`` as a replicated 0-d array
    (heat_tpu/core/linalg/qr.py:38).  For a row-split Q the split axis is
    the contraction: the overlap engine's ``rs`` ring with a replicated
    out-split (heat_tpu :51-63), or, where it declines, the positions'
    partial Gram matrices all-reduced."""
    sanitation.sanitize_in(q)
    gram = None
    if q.split == 0 and q.ndim == 2 and q.comm.size > 1:
        from ...parallel import overlap

        m, n = q.shape
        ring = overlap.matmul_raw(q.comm, [s.T for s in q.shards], q.shards, (n, m), (m, n), 1, 0, None)
        gram = ring[0] if ring is not None else collectives.psum([s.T @ s for s in q.shards])[0]
    else:
        arr = q.larray
        gram = arr.T @ arr
    defect = torch.max(torch.abs(gram - torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)))
    return DNDarray([defect] * q.comm.size, (), types.canonical_heat_type(defect.dtype), None, q.device, q.comm)


def _sign_normalise(q, r):
    """Flip signs so that R's diagonal is non-negative."""
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return (None if q is None else q * signs[None, :]), r * signs[:, None]


def _tsqr(a: DNDarray, calc_q: bool):
    """One-level TSQR tree over the row blocks (heat_tpu/core/linalg/qr.py:77)."""
    comm = a.comm
    n = a.shape[1]
    blocks = [s if s.is_floating_point() or s.is_complex() else s.to(torch.float32) for s in a.shards]
    q1s, r1s = [], []
    for b in blocks:
        rows = b.shape[0]
        if rows < n:
            # a short block factors as if padded with zero rows, as the JAX
            # package's even shards are
            b = torch.cat([b, b.new_zeros((n - rows, n))])
        q1, r1 = torch.linalg.qr(b, mode="reduced")
        q1s.append(q1[:rows])
        r1s.append(r1)
    q2, r = torch.linalg.qr(collectives.all_gather(r1s, dim=0)[0], mode="reduced")
    q2, r = _sign_normalise(q2, r)
    r_ht = _wrap(r, None, a.device, comm)
    if not calc_q:
        return None, r_ht
    qs = [q1 @ q2[i * n : (i + 1) * n] for i, q1 in enumerate(q1s)]
    q_ht = DNDarray(qs, a.shape, types.canonical_heat_type(qs[0].dtype), 0, a.device, comm)
    return q_ht, r_ht


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and widened to float32 again: a float32
    product of such operands equals JAX's bf16×bf16→f32 product."""
    return t.to(torch.bfloat16).to(torch.float32)


def _panel(x: torch.Tensor):
    """One panel pass's ``(r, rinv)``: K4 for float32, the plain chain for
    other dtypes."""
    if x.dtype == torch.float32:
        m, n = x.shape
        fp = telemetry.fingerprint(("qr_panel", m, n, str(x.dtype)))
        # K4's work: the Gram's upper triangle, m·n·(n+1) operations, and
        # the panel read once
        telemetry.ensure_program(fp, kind="kernel_qr_panel", ops=1, flops=float(m * n * (n + 1)),
                                 hbm_bytes=float(m * n * x.element_size()), dtype=str(x.dtype))
        return telemetry.timed_call(fp, qr_panel.fused_gram_chol, x.contiguous(), device=x.device)
    return qr_panel.reference_fused_gram_chol(x)


def _chol_step(x: torch.Tensor, lowp: bool = False):
    """One CholeskyQR pass: ``(q, r)`` with ``r = chol(xᵀx)ᵀ``,
    ``q = x·r⁻¹`` (heat_tpu/core/linalg/qr.py:174)."""
    if lowp:
        xb = _bf16(x)
        l = qr_panel.cholesky_nan((xb.T @ xb).to(x.dtype))
        eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
        rinv = torch.linalg.solve_triangular(l, eye, upper=False).T
        return (xb @ _bf16(rinv)).to(x.dtype), l.T
    r, rinv = _panel(x)
    return x @ rinv, r


def _cholesky_qr2(arr: torch.Tensor, calc_q: bool = True, mixed: bool = False):
    """CholeskyQR2 (heat_tpu/core/linalg/qr.py:132): two passes, the first
    in bfloat16-rounded operands when ``mixed``.  Returns ``(q, r)``;
    ``q`` is None when not ``calc_q`` (the second pass's tall product is
    skipped)."""
    q1, r1 = _chol_step(arr, lowp=mixed)
    if calc_q:
        q, r2 = _chol_step(q1)
    else:
        q, r2 = None, _panel(q1)[0]
    return q, r2 @ r1


def _blocked_qr(arr: torch.Tensor, calc_q: bool = True, mixed: bool = False):
    """Blocked BCGS2 over CholeskyQR2 leaves (heat_tpu/core/linalg/qr.py:211)."""
    m, n = arr.shape
    if m >= 2 * n:
        return _cholesky_qr2(arr, calc_q=calc_q, mixed=mixed)
    n1 = n // 2
    a1, a2 = arr[:, :n1], arr[:, n1:]
    q1, r11 = _blocked_qr(a1, mixed=mixed)
    t1 = q1.T @ a2
    a2 = a2 - q1 @ t1
    t2 = q1.T @ a2  # reorthogonalise: CGS2
    a2 = a2 - q1 @ t2
    r12 = t1 + t2
    q2, r22 = _blocked_qr(a2, mixed=mixed, calc_q=calc_q)
    q = torch.cat([q1, q2], dim=1) if calc_q else None
    r = torch.cat(
        [torch.cat([r11, r12], dim=1), torch.cat([r22.new_zeros((r22.shape[0], n1)), r22], dim=1)], dim=0
    )
    return q, r


def qr(
    a: DNDarray,
    tiles_per_proc: int = 1,
    calc_q: bool = True,
    overwrite_a: bool = False,
    check: str = "eager",
    precision: str = "float32",
) -> QR:
    """QR decomposition of a 2-D array (heat_tpu/core/linalg/qr.py:257):
    ``QR(Q, R)`` with R upper triangular with a non-negative diagonal.

    ``tiles_per_proc`` and ``overwrite_a`` are accepted for API parity.
    ``calc_q=False`` returns ``QR(None, R)``.  ``check`` governs the
    Cholesky breakdown check of the GEMM routes: ``"eager"`` reads one flag
    back and falls back to Householder QR; ``"defer"`` skips the read, and
    a breakdown leaves NaN in Q and R.  ``precision="mixed"`` rounds the
    first CholeskyQR pass's operands to bfloat16.
    """
    sanitation.sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    if check not in ("eager", "defer"):
        raise ValueError(f'check must be "eager" or "defer", got {check!r}')
    if precision not in ("float32", "mixed"):
        raise ValueError(f'precision must be "float32" or "mixed", got {precision!r}')
    if a.dtype in (types.float16, types.bfloat16):
        # neither LAPACK nor cuSOLVER factors 16-bit floats; the JAX
        # package raises the same error
        raise NotImplementedError(f"Unsupported dtype {a.dtype.__name__}")

    m, n = a.shape
    r_split = 1 if a.split == 1 else None
    if a.split == 0 and a.comm.size > 1 and m >= n * a.comm.size:
        return QR(*_tsqr(a, calc_q))

    arr = a.larray
    if not (arr.is_floating_point() or arr.is_complex()):
        arr = arr.to(torch.float32)
    q = r = None
    if m >= n >= 2 and arr.is_floating_point():
        mixed = precision == "mixed"
        fact = _cholesky_qr2 if m >= 2 * n else _blocked_qr
        if arr.dtype == torch.float32 and autotune.site_tunes(arr):
            # K4's one-arm row under heat_tpu's key (qr.py:349-365): the
            # kernel launches whatever the table holds
            dt = autotune.dtype_name(arr.dtype)
            fp_k = telemetry.fingerprint(("qr_panel_fused", m, n, dt, calc_q))
            telemetry.ensure_program(fp_k, kind="kernel_qr_panel", ops=1, flops=4.0 * m * n * n,
                                     hbm_bytes=3.0 * m * n * arr.element_size(), mesh={"devices": a.comm.size},
                                     dtype=dt)
            key = autotune.kernel_key("qr_panel", m, n, dt, calc_q, a.comm.size)
            q, r = autotune.kernel_site(key, f"qr {m}x{n} {dt}", fact, arr, calc_q, mixed, fp=fp_k,
                                        device=arr.device)
        else:
            q, r = fact(arr, calc_q, mixed)
        # "eager": one read of a flag per call; a failed Cholesky has
        # NaN-latched R, and the call falls back to Householder
        if check == "eager" and not bool(torch.isfinite(r).all()):
            q = r = None
    if r is None:
        q, r = _sign_normalise(*torch.linalg.qr(arr, mode="reduced"))
    q_ht = _wrap(q, a.split, a.device, a.comm) if calc_q else None
    return QR(q_ht, _wrap(r, r_split, a.device, a.comm))
