"""Decoder-only Transformer LM with mesh-parallel attention (counterpart of
heat_tpu/models/transformer.py).

The modules keep the flax modules' fields, defaults and arithmetic, in f32:

* LayerNorm is flax's ``nn.LayerNorm(use_bias=False)``: epsilon 1e-6, the
  fast variance E[x²] − E[x]² clipped at 0, no bias.
* The MLP's activation is flax's ``nn.gelu``, whose default is the tanh
  approximation.
* Projection weights keep flax's (in, out) layout and are applied as
  ``x @ W``: the fused q/k/v kernel is (D, 3, heads, head_dim) and the
  output projection reads heads in (batch, seq, heads·head_dim) order.
* The readout is tied to the token embedding: ``x @ embedding.T``.

Attention runs through K3 (:func:`~heat_tpu_torch.ops.flash_attention`),
one launch per layer, or sequence-parallel over ``sp_mesh`` (a
:class:`~heat_tpu_torch.parallel.mesh.MeshComm`) with
``attention="ring"`` or ``"ulysses"``.  Parameters are made on an explicit
device from an explicit ``torch.Generator`` with flax's initialisers
(truncated-normal LeCun kernels, normal embeddings of std 1/sqrt(D), unit
scales); :func:`~heat_tpu_torch.models.convert.transformer_from_flax` loads
a flax parameter tree instead.  The mixture-of-experts MLP is not ported
yet (ROADMAP item 12, ``parallel/expert.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.devices import Device, sanitize_device
from ..ops.attention import flash_attention
from ..parallel.sequence import sequence_parallel_attention

__all__ = ["LayerNorm", "MultiHeadAttention", "TransformerBlock", "TransformerLM"]

# flax's truncated normal cuts at two standard deviations of the unscaled
# normal and divides by that distribution's std, so the result has std 1
_TRUNC_STD = 0.87962566103423978


def _torch_device(device: Union[None, str, Device, torch.device]) -> torch.device:
    return sanitize_device(device).torch_device


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: truncated normal of std 1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(use_bias=False)`` over the last dimension."""

    def __init__(self, dim: int, *, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim, device=_torch_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        return (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)


class MultiHeadAttention(nn.Module):
    """Causal multi-head attention through flash attention, optionally
    sequence-parallel (heat_tpu/models/transformer.py:20).

    ``dim`` is the input width (flax infers it from the first call); it
    defaults to ``num_heads * head_dim``.  ``sp_axis`` is kept for parity
    with the JAX fields: a :class:`MeshComm` has one axis."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        attention: str = "flash",
        sp_mesh=None,
        sp_axis: str = "sp",
        *,
        dim: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if attention not in ("flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention {attention!r}: use 'flash', 'ring' or 'ulysses'")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.attention, self.sp_mesh, self.sp_axis = attention, sp_mesh, sp_axis
        dim = num_heads * head_dim if dim is None else dim
        dev = _torch_device(device)
        self.qkv = nn.Parameter(torch.empty(dim, 3, num_heads, head_dim, device=dev))
        self.out = nn.Parameter(torch.empty(num_heads * head_dim, dim, device=dev))
        _lecun_normal_(self.qkv, dim, generator)
        _lecun_normal_(self.out, num_heads * head_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = (x @ self.qkv.reshape(dim, 3 * h * d)).reshape(b, s, 3, h, d)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # each (b, h, s, d)
        if self.attention in ("ring", "ulysses"):
            if self.sp_mesh is None:
                raise ValueError("sequence-parallel attention needs sp_mesh")
            out = sequence_parallel_attention(q, k, v, self.sp_mesh, causal=True, strategy=self.attention)
        else:
            out = flash_attention(q, k, v, causal=True)
        return out.transpose(1, 2).reshape(b, s, h * d) @ self.out


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + MLP(LN(x))
    (heat_tpu/models/transformer.py:113)."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        mlp_ratio: int = 4,
        attention: str = "flash",
        sp_mesh=None,
        sp_axis: str = "sp",
        moe_experts: int = 0,
        moe_k: int = 2,
        moe_capacity_factor: float = 2.0,
        ep_mesh=None,
        ep_axis: str = "ep",
        *,
        dim: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "the mixture-of-experts MLP (moe_experts > 0) is not ported yet: ROADMAP item 12, parallel/expert.py"
            )
        dim = num_heads * head_dim if dim is None else dim
        hidden = dim * mlp_ratio
        dev = _torch_device(device)
        self.norm1 = LayerNorm(dim, device=dev)
        self.attn = MultiHeadAttention(
            num_heads, head_dim, attention, sp_mesh, sp_axis, dim=dim, device=dev, generator=generator
        )
        self.norm2 = LayerNorm(dim, device=dev)
        self.mlp_in = nn.Parameter(torch.empty(dim, hidden, device=dev))
        self.mlp_out = nn.Parameter(torch.empty(hidden, dim, device=dev))
        _lecun_normal_(self.mlp_in, dim, generator)
        _lecun_normal_(self.mlp_out, hidden, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        y = F.gelu(self.norm2(x) @ self.mlp_in, approximate="tanh")
        return x + y @ self.mlp_out


class TransformerLM(nn.Module):
    """Decoder-only language model (heat_tpu/models/transformer.py:150):
    ``forward(tokens)`` maps (batch, seq) token ids to (batch, seq, vocab)
    logits.

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``) when
    gradients are being recorded, trading recomputation for memory as
    ``nn.remat`` does.  ``device`` defaults to the card."""

    def __init__(
        self,
        vocab_size: int = 32000,
        num_layers: int = 4,
        num_heads: int = 8,
        head_dim: int = 64,
        mlp_ratio: int = 4,
        max_seq_len: int = 2048,
        attention: str = "flash",
        sp_mesh=None,
        sp_axis: str = "sp",
        moe_experts: int = 0,
        moe_k: int = 2,
        moe_capacity_factor: float = 2.0,
        ep_mesh=None,
        ep_axis: str = "ep",
        remat: bool = False,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim, self.mlp_ratio = num_heads, head_dim, mlp_ratio
        self.max_seq_len, self.attention, self.remat = max_seq_len, attention, remat
        dim = num_heads * head_dim
        dev = _torch_device(device)
        self.embed = nn.Parameter(torch.empty(vocab_size, dim, device=dev))
        self.pos_embed = nn.Parameter(torch.empty(max_seq_len, dim, device=dev))
        # flax's Embed initialiser: normal of std 1/sqrt(features)
        nn.init.normal_(self.embed, std=1.0 / math.sqrt(dim), generator=generator)
        nn.init.normal_(self.pos_embed, std=1.0 / math.sqrt(dim), generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                num_heads, head_dim, mlp_ratio, attention, sp_mesh, sp_axis, moe_experts, moe_k,
                moe_capacity_factor, ep_mesh, ep_axis, device=dev, generator=generator,
            )
            for _ in range(num_layers)
        )
        self.final_norm = LayerNorm(dim, device=dev)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.embed.device)
        seq = tokens.shape[-1]
        if seq > self.max_seq_len:
            raise ValueError(f"sequence of {seq} tokens exceeds max_seq_len {self.max_seq_len}")
        x = self.embed[tokens] + self.pos_embed[:seq][None]
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.final_norm(x) @ self.embed.T
