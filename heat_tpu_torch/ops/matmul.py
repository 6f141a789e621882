"""Blocked 2-D matrix product, K2 of the port (counterpart of
heat_tpu/ops/matmul.py, whose Pallas kernel ``_mm_kernel`` this replaces).

:func:`matmul` launches the hand-written CUDA kernel in ``csrc/matmul.cu``
for tensors on the card; for tensors on the CPU it computes
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

#: rows of the output per block of the kernel
BLOCK_M = 128

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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul(a: torch.Tensor, b: torch.Tensor, *, block: int = 512) -> torch.Tensor:
    """``a @ b`` for 2-D a (m, k) and b (k, n), in a's dtype
    (heat_tpu/ops/matmul.py:84).

    ``block`` is accepted for parity with the JAX signature and changes no
    values: the kernel's tiles are fixed.  On the card a and b must share
    one of float32, bfloat16, float16 and one device; an empty result
    returns without a launch."""
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
    if max(m, n, k) >= 2**31 or -(-m // BLOCK_M) > 65535:
        raise ValueError(f"shape ({m},{k})x({k},{n}) exceeds the kernel's grid")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed with cudaError_t {err}")
    launches += 1
    return out
