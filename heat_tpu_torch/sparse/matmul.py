"""Sparse times dense (counterpart of heat_tpu/sparse/matmul.py): ``matmul``
and the Lanczos operator ``matvec_program``.

``matmul(A, x)`` computes ``A @ x`` for a :class:`DCSR_matrix` and a dense
vector or matrix, position by position against the whole of x.  By the
computation's dtype, as the JAX package's static dispatch declines its
kernel:

* float32 values and a float32 computation go through K6
  (:mod:`heat_tpu_torch.ops.spmv`) over each position's repacking by
  column panel: on the card one launch per position and call, with all k
  right-hand sides in that launch; on the CPU its plain version;
* any other dtype takes the CSR gather: per-entry products
  ``data[e]·x[indices[e]]`` summed into their rows (the JAX package's
  ``gather`` arm, ``_gather_block``).

Each position's repacking (``ops.spmv.csr_panels``) is built from its CSR
triple on the matrix's device at first use, cached on the matrix and
ledgered as ``staging`` (:mod:`~heat_tpu_torch.core.memtrack`).  Each
product is a ledger entry (:mod:`~heat_tpu_torch.core.telemetry`): the
kernel path's with K6's work count, the gather's without one.
On a CUDA tensor with the tuning plane on, the kernel path keeps a one-arm
``("kernel",)`` row under the JAX package's ``spmv_csr`` key: K6 launches
whatever the table holds.  The JAX package's dense/gather/kernel arms and
its ``HEAT_TPU_SPMV`` route switch are not ported, by design: the kernel is
the one f32 path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import autotune, memtrack, sanitation, telemetry, types
from ..core.dndarray import DNDarray
from ..ops import spmv as _k6
from ._operations import _expand_rows
from .dcsr_matrix import DCSR_matrix

__all__ = ["matmul", "matvec_program"]


def _panels(A: DCSR_matrix) -> List[_k6.Panels]:
    """Each position's repacking for K6; built at first use and cached on
    the matrix."""
    if A._spmv_panels is None:
        A._spmv_panels = [_k6.csr_panels(d, i, p, A.shape[1]) for d, i, p in A._shards]
        for panels in A._spmv_panels:
            memtrack.register_shards([panels.vals, panels.cols, panels.off], tag="staging", split=A.split)
    return A._spmv_panels


def _geometry(A: DCSR_matrix) -> dict:
    """heat_tpu's spelling of the matrix's sparsity geometry for the tuning
    key (heat_tpu/sparse/matmul.py:58): its slab capacity (the most entries
    a position holds, at least 1) and the ELL width of its densest row
    (rounded up to 128 lanes).  One host read of the row lengths, cached on
    the matrix."""
    got = getattr(A, "_spmv_geom", None)
    if got is None:
        max_row = max((int(torch.diff(p).max()) for _, _, p in A._shards if p.numel() > 1), default=0)
        got = {"cap": max(1, max(A.lnnz_all, default=1)), "width": max(128, -(-max(1, max_row) // 128) * 128)}
        A._spmv_geom = got
    return got


def _gather_block(data: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """One position's CSR product as gather and segment sum."""
    rows = _expand_rows(ptr, data.numel())
    contrib = data.to(x2.dtype)[:, None] * x2.index_select(0, idx)
    out = torch.zeros((ptr.numel() - 1, x2.shape[1]), dtype=x2.dtype, device=x2.device)
    return out.index_add_(0, rows, contrib)


def _uses_kernel(A: DCSR_matrix, dtype) -> bool:
    return A.dtype is types.float32 and dtype is types.float32


def _operand(x, A: DCSR_matrix) -> torch.Tensor:
    if isinstance(x, DNDarray):
        return x.larray.to(A.device.torch_device)
    if isinstance(x, torch.Tensor):
        return x.to(A.device.torch_device)
    return torch.as_tensor(np.asarray(x), device=A.device.torch_device)


def matmul(A: DCSR_matrix, x, out: Optional[DNDarray] = None) -> DNDarray:
    """``A @ x`` for a DCSR matrix and a dense (ncols,) or (ncols, k) ``x``
    (a DNDarray or array-like).  The result is dense, row-split when ``A``
    is, with the promoted float dtype (float32 for integer operands)."""
    if not isinstance(A, DCSR_matrix):
        raise TypeError(f"A must be a DCSR_matrix, got {type(A)}")
    xv = _operand(x, A)
    if xv.ndim not in (1, 2):
        raise ValueError(f"x needs to be 1-D or 2-D, but was {xv.ndim}-D")
    if xv.shape[0] != A.shape[1]:
        raise ValueError(f"dimension mismatch: A is {A.shape}, x leads with {xv.shape[0]}")
    cdt = types.promote_types(A.dtype, types.canonical_heat_type(xv.dtype))
    if not issubclass(cdt, types.floating):
        cdt = types.float32
    vec = xv.ndim == 1
    x2 = (xv[:, None] if vec else xv).to(cdt.torch_type())
    n, ncols = A.shape
    k = x2.shape[1]
    if _uses_kernel(A, cdt):
        fp = telemetry.fingerprint(("spmv_kernel", n, ncols, k, A.nnz, str(x2.dtype)))
        # K6's work: two operations an entry and column; each value, column
        # index and x read once, y written once
        telemetry.ensure_program(fp, kind="kernel_spmv", ops=1, flops=2.0 * A.nnz * k,
                                 hbm_bytes=float(A.nnz * 8 + (ncols + n) * k * 4),
                                 mesh={"devices": A.comm.size}, dtype=str(x2.dtype))
        run = lambda: [_k6.spmv(panels, x2) for panels in _panels(A)]  # noqa: E731
        if autotune.site_tunes(x2):
            # K6's one-arm row under heat_tpu's spmv_csr key
            # (sparse/matmul.py:312-340): the kernel launches whatever the
            # table holds
            g = _geometry(A)
            dt = autotune.dtype_name(x2.dtype)
            key = autotune.spmv_key("spmv_csr", n, ncols, k, int(A.nnz).bit_length(), g["cap"], g["width"], dt,
                                    A.comm.size)
            blocks = autotune.kernel_site(key, f"spmv {n}x{ncols} nnz={A.nnz} k={k} {dt}", run, fp=fp,
                                          device=x2.device)
        else:
            blocks = telemetry.timed_call(fp, run, device=x2.device)
    else:
        fp = telemetry.fingerprint(("spmv_gather", n, ncols, k, A.nnz, str(x2.dtype)))
        telemetry.ensure_program(fp, kind="spmv_gather", ops=1, mesh={"devices": A.comm.size}, dtype=str(x2.dtype))
        blocks = telemetry.timed_call(fp, lambda: [_gather_block(d, i, p, x2) for d, i, p in A._shards],
                                      device=x2.device)
    if vec:
        blocks = [b.reshape(-1) for b in blocks]
    if not A.is_distributed():
        blocks = blocks * A.comm.size
    shape = (A.shape[0],) if vec else (A.shape[0], x2.shape[1])
    result = DNDarray(blocks, shape, cdt, 0 if A.split == 0 else None, A.device, A.comm)
    if out is not None:
        return sanitation.sanitize_out(out, result)
    return result


def _apply_panels(operands, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([_k6.spmv(panels, v) for panels in operands])


def _apply_gather(operands, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([_gather_block(d, i, p, v[:, None])[:, 0] for d, i, p in operands])


def matvec_program(A: DCSR_matrix):
    """``(apply_fn, operands)`` with ``apply_fn(operands, v) = A @ v`` for a
    vector ``v`` of the whole column space, for the Lanczos loop: K6 over the
    repacking for a float32 matrix, the CSR gather otherwise.  Never dense."""
    if A.dtype is types.float32:
        return _apply_panels, _panels(A)
    return _apply_gather, A._shards
