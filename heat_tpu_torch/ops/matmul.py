"""Blocked 2-D matrix product, K2 of the port (counterpart of
heat_tpu/ops/matmul.py, whose Pallas kernel ``_mm_kernel`` this replaces).

:func:`matmul` launches the hand-written CUDA kernel in ``csrc/matmul.cu``
for tensors on the card (f32 on the CUDA cores, bf16 and f16 on the tensor
cores); for tensors on the CPU it computes
:func:`reference_matmul`, the plain version.  There is no fallback between
the two: a CUDA tensor the kernel does not take raises.  The package
exports it as ``ops.pallas_matmul``, as heat_tpu/ops/__init__.py does.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["matmul", "reference_matmul"]

#: kernel launches so far; :func:`matmul` adds one per launch and nowhere else
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SOURCES = ("matmul.cu",)
_fn = None


def reference_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the product accumulated in (at least) f32, then
    cast to a's dtype (the Pallas kernel's f32 scratch and ``out_shape``,
    heat_tpu/ops/matmul.py:33-45, :71)."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_matmul", _SOURCES).heat_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul(a: torch.Tensor, b: torch.Tensor, *, block: int = 512) -> torch.Tensor:
    """``a @ b`` for 2-D a (m, k) and b (k, n), in a's dtype
    (heat_tpu/ops/matmul.py:84).

    ``block`` is accepted for parity with the JAX signature and changes no
    values: the kernel's tiles are fixed.  On the card a and b must share
    one of float32, bfloat16, float16 and one device; f32 runs on the CUDA
    cores, bf16 and f16 on the tensor cores.  An empty result returns
    without a launch."""
    global launches
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"pallas matmul is 2-D only, got {a.ndim}-D @ {b.ndim}-D")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return reference_matmul(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul needs a and b on one CUDA device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"the matmul kernel takes a and b of one of float32, bfloat16, float16; got {a.dtype} and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2**31:
        raise ValueError(f"shape ({m},{k})x({k},{n}) exceeds the kernel's grid")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lda, ldb = k, n
    if a.dtype != torch.float32:
        (a, lda), (b, ldb) = tma_rows(a), tma_rows(b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, lda, ldb, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


def tma_rows(t: torch.Tensor):
    """``t`` and its row stride in elements, for a kernel that loads ``t``
    by TMA, which needs a 16-byte aligned base and rows of 16-bit values a
    multiple of 8: ``t`` itself when it qualifies, else a copy into a fresh
    (aligned) buffer whose rows are rounded up to 8 values.  The kernels'
    tensor maps span the real row, so the pad is never read."""
    cols = t.shape[-1]
    ld = -(-cols // 8) * 8
    if ld == cols and t.data_ptr() % 16 == 0:
        return t, cols
    buf = t.new_empty(t.shape[:-1] + (ld,))
    buf[..., :cols].copy_(t)
    return buf, ld
