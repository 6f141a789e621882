"""Fused pairwise squared-Euclidean distance, K1 of the port (counterpart of
heat_tpu/ops/cdist.py, whose Pallas kernel ``_cdist_kernel`` this replaces).

:func:`cdist` launches the hand-written CUDA kernel in ``csrc/cdist.cu`` for
a tensor on the card (f32, or bf16/f16 x against y of its type or f32);
for a tensor on the CPU it computes :func:`reference_cdist`, the same
function in plain torch ops.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["cdist", "reference_cdist"]

#: kernel launches so far; :func:`cdist` adds one per launch and nowhere else
launches = 0

_SOURCES = ("cdist.cu",)
_fn = None
_fn16 = None
# the 16-bit entry point's type codes; x is 16-bit, y has x's type or is f32
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16),
    (torch.float16, torch.float32),
}


def reference_cdist(x: torch.Tensor, y: torch.Tensor, sqrt: bool = True) -> torch.Tensor:
    """The plain version: ‖x‖² + ‖y‖² − 2·x·yᵀ in f32, clamped at 0, with an
    optional sqrt; (m,d)×(n,d) → (m,n) f32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xsq = torch.sum(x * x, dim=1, keepdim=True)
    ysq = torch.sum(y * y, dim=1)[None, :]
    d2 = torch.clamp(xsq + ysq - 2.0 * (x @ y.T), min=0.0)
    return torch.sqrt(d2) if sqrt else d2


def _kernel():
    """The f32 entry point; loads (and at first use builds) the library,
    whose 16-bit entry point :func:`cdist` then finds in ``_fn16``."""
    global _fn, _fn16
    if _fn is None:
        from ._build import load

        lib = load("heat_cdist", _SOURCES)
        fn16 = lib.heat_cdist_16
        fn16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn16.restype = ctypes.c_int
        fn = lib.heat_cdist_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn16, _fn = fn16, fn
    return _fn


def cdist(x: torch.Tensor, y: torch.Tensor, sqrt: bool = True) -> torch.Tensor:
    """Pairwise (squared if ``sqrt=False``) Euclidean distances,
    (m,d)×(n,d) → (m,n) f32.

    On the card, x and y must be contiguous and on one device, both f32, or
    x bf16/f16 with y of x's type or f32 (the kernel widens the 16-bit tiles
    itself, as the TPU kernel does); an empty result returns without a
    launch (a grid of zero blocks is an invalid launch)."""
    global launches
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError("cdist expects 2-D inputs")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dimensions differ: {x.shape[1]} vs {y.shape[1]}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return reference_cdist(x, y, sqrt=sqrt)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"cdist needs x and y on one CUDA device, got {x.device} and {y.device}")
    if (x.dtype, y.dtype) not in _PAIRS:
        raise TypeError(
            f"the cdist kernel takes float32, or bfloat16/float16 x against y of its type or float32; "
            f"got {x.dtype} and {y.dtype}"
        )
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the cdist kernel takes contiguous row-major inputs")
    m, d = x.shape
    n = y.shape[0]
    if max(m, n, d) >= 2**31 or n > 64 * 65535:
        raise ValueError(f"shape ({m},{d})x({n},{d}) exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = _kernel()
        if x.dtype == torch.float32:
            err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d, int(sqrt), stream)
        else:
            err = _fn16(
                x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d, int(sqrt),
                _CODES[x.dtype], _CODES[y.dtype], stream,
            )
    if err != 0:
        raise RuntimeError(f"cdist kernel launch failed with cudaError_t {err}")
    launches += 1
    return out
