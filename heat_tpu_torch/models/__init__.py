"""Models (counterpart of heat_tpu/models): so far the decoder-only
:class:`TransformerLM` with its blocks, and the converter from a flax
parameter tree.  The MLP, the ResNets and the mixture-of-experts MLP are
not ported yet (ROADMAP item 12)."""

from . import convert, transformer
from .convert import transformer_from_flax
from .transformer import LayerNorm, MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = [
    "LayerNorm",
    "MultiHeadAttention",
    "TransformerBlock",
    "TransformerLM",
    "convert",
    "transformer",
    "transformer_from_flax",
]
