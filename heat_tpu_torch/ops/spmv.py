"""Sparse matrix times dense vectors over ELL slabs, K6 of the port
(counterpart of heat_tpu/ops/spmv.py, whose Pallas kernel ``_spmv_kernel``
this replaces).

A CSR row block is repacked into ELL slabs ``(vals (rows, W) f32,
cols (rows, W) int32)``: row r's entries fill its first slots in column
order, and the pad slots carry value 0 and column −1.  :func:`ell_pack`
builds them with torch ops on the tensors' own device, so a matrix on the
card is packed on the card.  The width W is the densest row rounded up to
a multiple of 32 (one warp; the JAX package rounds to the TPU's 128 lanes),
and the rows are not padded.

:func:`spmv_ell` launches the hand-written CUDA kernel in ``csrc/spmv.cu``
for tensors on the card; for tensors on the CPU it computes
:func:`reference_spmv_ell`, the same function in plain torch ops.  There is
no fallback between the two: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["ell_pack", "ell_width", "reference_spmv_ell", "spmv_ell"]

#: kernel launches so far; :func:`spmv_ell` adds one per launch and nowhere else
launches = 0

#: slab widths are multiples of one warp
WARP = 32

_SOURCES = ("spmv.cu",)
_fn = None


def ell_width(max_row_nnz: int) -> int:
    """ELL slab width for a row block whose densest row holds
    ``max_row_nnz`` entries: rounded up to a multiple of 32, at least 32."""
    need = max(1, int(max_row_nnz))
    return -(-need // WARP) * WARP


def ell_pack(data: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor, width: int):
    """Repack one CSR triple (``indptr`` over its rows, rebased to 0) into
    ELL slabs ``(vals (rows, width) f32, cols (rows, width) int32)`` on the
    triple's device.  Pad slots carry value 0 and column −1."""
    indptr = indptr.to(torch.int64)
    rows = indptr.numel() - 1
    nnz = data.numel()
    dev = data.device
    counts = indptr[1:] - indptr[:-1]
    vals = torch.zeros((rows, width), dtype=torch.float32, device=dev)
    cols = torch.full((rows, width), -1, dtype=torch.int32, device=dev)
    if nnz:
        if int(counts.max()) > width:
            raise ValueError(f"a row with {int(counts.max())} entries exceeds the slab width {width}")
        row_of = torch.repeat_interleave(torch.arange(rows, device=dev), counts, output_size=nnz)
        flat = row_of * width + torch.arange(nnz, device=dev) - indptr[:-1][row_of]
        vals.view(-1)[flat] = data.to(torch.float32)
        cols.view(-1)[flat] = indices.to(torch.int32)
    return vals, cols


def reference_spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``y[r] = Σⱼ vals[r, j]·x[cols[r, j]]`` with pad
    slots (``cols < 0``) adding 0, in f32; x is (ncols,) or (ncols, k) and y
    (rows,) or (rows, k)."""
    vec = x.ndim == 1
    x2 = (x[:, None] if vec else x).to(torch.float32)
    live = cols >= 0
    safe = torch.where(live, cols, torch.zeros((), dtype=cols.dtype, device=cols.device))
    g = x2.index_select(0, safe.reshape(-1)).reshape(*cols.shape, x2.shape[1])
    prod = torch.where(live[..., None], vals.to(torch.float32)[..., None] * g, torch.zeros((), device=g.device))
    y = prod.sum(dim=1)
    return y[:, 0] if vec else y


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_spmv", _SOURCES).heat_spmv_ell_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A·x`` for A in ELL slabs ``vals``/``cols`` (rows, W) and x of
    shape (ncols,) or (ncols, k); y is (rows,) or (rows, k) f32.

    On the card: vals f32 and cols int32, contiguous, with W a multiple of
    32; x f32; all on one device.  A zero-row block or k = 0 returns
    without a launch.  The kernel trusts every column id to be below
    ncols (:func:`ell_pack` of a valid CSR triple guarantees it)."""
    global launches
    if vals.ndim != 2 or cols.shape != vals.shape:
        raise ValueError(f"ELL slabs must be two 2-D arrays of one shape, got {tuple(vals.shape)} and {tuple(cols.shape)}")
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be 1-D or 2-D, got {x.ndim}-D")
    if all(t.device.type == "cpu" for t in (vals, cols, x)):
        return reference_spmv_ell(vals, cols, x)
    if vals.device.type != "cuda" or cols.device != vals.device or x.device != vals.device:
        raise ValueError(f"spmv_ell needs its operands on one CUDA device, got {vals.device}, {cols.device}, {x.device}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"the spmv kernel takes float32 values and x, got {vals.dtype} and {x.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"the spmv kernel takes int32 column ids, got {cols.dtype}")
    rows, width = vals.shape
    if width % WARP:
        raise ValueError(f"the spmv kernel takes a slab width that is a multiple of {WARP}, got {width}")
    vec = x.ndim == 1
    x2 = (x[:, None] if vec else x).contiguous()
    k = x2.shape[1]
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("the spmv kernel takes contiguous row-major slabs")
    if any(t.data_ptr() % 16 for t in (vals, cols)):
        raise ValueError("the spmv kernel takes 16-byte aligned slabs")
    if max(rows, width, x2.shape[0]) >= 2**31 or k > 4 * 65535:
        raise ValueError(f"slabs ({rows},{width}) with k={k} exceed the kernel's grid")
    y = torch.empty((rows, k), dtype=torch.float32, device=vals.device)
    if rows and k:
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream(vals.device).cuda_stream
            err = _kernel()(vals.data_ptr(), cols.data_ptr(), x2.data_ptr(), y.data_ptr(), rows, width, k, stream)
        if err != 0:
            raise RuntimeError(f"spmv kernel launch failed with cudaError_t {err}")
        launches += 1
    return y[:, 0] if vec else y
