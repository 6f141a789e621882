"""Flash attention, K3 of the port (counterpart of heat_tpu/ops/attention.py,
whose Pallas kernel ``_flash_kernel`` this replaces).

:func:`flash_attention` takes the ``(..., seq, head_dim)`` layout and
flattens the leading dimensions (batch, heads) into one, as the JAX
function does.  Its forward launches the hand-written CUDA kernel in
``csrc/attention.cu`` for tensors on the card (f32 on the CUDA cores,
bf16 and f16 on the tensor cores); for tensors on the CPU it computes
:func:`reference_flash_attention`, the plain version (the JAX package's
``_attention_ref``).  There is no fallback between the two: a CUDA
tensor the kernel does not take raises.

The backward is not a kernel, in either package: ``_flash_bwd``
(heat_tpu/ops/attention.py:165) recomputes through ``_attention_ref`` under
``jax.custom_vjp``, and :class:`_Flash` recomputes through the plain version
under ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = ["flash_attention", "reference_flash_attention"]

#: kernel launches so far; the forward adds one per launch and nowhere else
launches = 0

#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 256
#: query rows per block of the kernel
BLOCK_Q = 64

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SOURCES = ("attention.cu",)
_fn = None


def reference_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, scale: Optional[float] = None
) -> torch.Tensor:
    """The plain version, ``_attention_ref`` (heat_tpu/ops/attention.py:143):
    scores in f32, masked to -1e30 above the top-left causal diagonal, a
    softmax, and p rounded to q's dtype before the product with v."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("...qd,...kd->...qk", q, k).to(torch.float32) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sq, device=s.device)[:, None] >= torch.arange(sk, device=s.device)[None, :]
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(q.dtype), v)


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_attention", _SOURCES).heat_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float) -> torch.Tensor:
    """One forward over (bh, sq, d) x (bh, sk, d): the kernel on the card,
    the plain version on the CPU."""
    global launches
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return reference_flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k and v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the attention kernel takes one of float32, bfloat16, float16 for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes 1 <= head_dim <= {MAX_HEAD_DIM}, got {d}")
    if bh >= 2**31 or max(sq, sk) >= 2**31 or -(-sq // BLOCK_Q) > 65535:
        raise ValueError(f"attention of shape ({bh},{sq},{d})x({bh},{sk},{d}) exceeds the kernel's grid")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    if bh == 0 or sq == 0:
        return out
    ld = d
    if q.dtype != torch.float32:
        from .matmul import tma_rows

        (q, ld), (k, _), (v, _) = (tma_rows(t) for t in (q, k, v))  # one ld: it depends on d alone
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk, d, ld, scale, int(causal),
            _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


class _Flash(torch.autograd.Function):
    """Forward through the kernel, backward by recomputing the plain version
    (``_flash`` under ``jax.custom_vjp``, heat_tpu/ops/attention.py:153-171)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_flash_attention(q, k, v, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, scale: Optional[float] = None
) -> torch.Tensor:
    """Scaled dot-product attention on the ``(..., seq, head_dim)`` layout
    (heat_tpu/ops/attention.py:174).

    The leading dimensions (batch, heads) are flattened into one; q may have
    another sequence length than k and v.  ``scale`` defaults to
    1/sqrt(head_dim).  The causal mask is top-left aligned on absolute
    indices (query i sees keys j <= i).  The output has q's dtype; the
    softmax and the accumulation are f32.  On the card f32 runs on the CUDA
    cores; bf16 and f16 run on the tensor cores, with p rounded to the
    input's type before its product with v, as in the plain version."""
    if q.shape[:-2] != k.shape[:-2] or k.shape != v.shape or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"incompatible attention shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    lead = q.shape[:-2]
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    bh = math.prod(lead)
    q3 = q.reshape((bh,) + tuple(q.shape[-2:]))
    k3 = k.reshape((bh,) + tuple(k.shape[-2:]))
    v3 = v.reshape((bh,) + tuple(v.shape[-2:]))
    out = _Flash.apply(q3, k3, v3, bool(causal), float(scale))
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))
