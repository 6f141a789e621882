"""Models (counterpart of heat_tpu/models): the MLP, the ResNets, the
decoder-only :class:`TransformerLM` with its blocks and the
mixture-of-experts :class:`MoEMlp`, and the converters from flax variable
trees."""

from . import convert, mlp, resnet, transformer
from .convert import mlp_from_flax, resnet_from_flax, transformer_from_flax
from .mlp import MLP
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from .transformer import LayerNorm, MoEMlp, MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = [
    "LayerNorm",
    "MLP",
    "MoEMlp",
    "MultiHeadAttention",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "TransformerBlock",
    "TransformerLM",
    "convert",
    "mlp",
    "mlp_from_flax",
    "resnet",
    "resnet_from_flax",
    "transformer",
    "transformer_from_flax",
]
