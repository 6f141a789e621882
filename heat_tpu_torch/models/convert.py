"""Carry flax models' variables into the port: the TransformerLM, the MLP
and the ResNets.

``heat_tpu.models.TransformerLM.init`` gives a nested dict under
``params``: ``embed/embedding``, ``pos_embed/embedding``,
``final_norm/scale`` and, per layer i, ``block_i/{LayerNorm_0,LayerNorm_1}/scale``,
``block_i/attn/qkv/kernel`` (D, 3, h, d), ``block_i/attn/out/kernel``
(h·d, D), ``block_i/mlp_in/kernel`` (D, 4D) and ``block_i/mlp_out/kernel``
(4D, D).  The converter takes that tree with numpy leaves, so it needs
neither jax nor flax, and keeps every kernel in flax's (in, out)
layout, which the port applies as ``x @ W``.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from .mlp import MLP
from .resnet import BasicBlock, BottleneckBlock, ResNet
from .transformer import TransformerLM, _torch_device

__all__ = ["mlp_from_flax", "resnet_from_flax", "transformer_from_flax"]


def _tensor(leaf: Any, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(dev)


def transformer_from_flax(params: Mapping[str, Any], *, device=None, **config) -> TransformerLM:
    """The port's :class:`TransformerLM` holding ``params``, a flax
    parameter tree (with or without its top-level ``"params"`` key), on
    ``device`` (the card by default).

    The widths (``vocab_size``, ``num_layers``, ``num_heads``, ``head_dim``,
    ``mlp_ratio``, ``max_seq_len``) are read from the tree's shapes; a
    width given in ``config`` must agree with them.  The other fields of
    ``config`` (``attention``, ``sp_mesh``, ``remat``, ...) pass through."""
    p = params["params"] if set(params) == {"params"} else params
    vocab, dim = np.shape(p["embed"]["embedding"])
    layers = sorted(int(key.split("_")[1]) for key in p if key.startswith("block_"))
    if layers != list(range(len(layers))):
        raise ValueError(f"the tree's blocks are not block_0 .. block_{len(layers) - 1}: {layers}")
    first = p["block_0"] if layers else None
    shapes = dict(
        vocab_size=int(vocab),
        num_layers=len(layers),
        max_seq_len=int(np.shape(p["pos_embed"]["embedding"])[0]),
    )
    if first is not None:
        _, three, heads, head_dim = np.shape(first["attn"]["qkv"]["kernel"])
        if three != 3:
            raise ValueError(f"block_0/attn/qkv/kernel has shape {np.shape(first['attn']['qkv']['kernel'])}, not (D, 3, h, d)")
        shapes.update(num_heads=int(heads), head_dim=int(head_dim),
                      mlp_ratio=int(np.shape(first["mlp_in"]["kernel"])[1]) // int(dim))
    for key, value in shapes.items():
        if key in config and config[key] != value:
            raise ValueError(f"{key}={config[key]} disagrees with the parameters' {value}")
    dev = _torch_device(device)
    model = TransformerLM(**{**config, **shapes}, device=dev)
    with torch.no_grad():
        model.embed.copy_(_tensor(p["embed"]["embedding"], dev))
        model.pos_embed.copy_(_tensor(p["pos_embed"]["embedding"], dev))
        model.final_norm.scale.copy_(_tensor(p["final_norm"]["scale"], dev))
        for i, block in enumerate(model.blocks):
            src = p[f"block_{i}"]
            block.norm1.scale.copy_(_tensor(src["LayerNorm_0"]["scale"], dev))
            block.norm2.scale.copy_(_tensor(src["LayerNorm_1"]["scale"], dev))
            block.attn.qkv.copy_(_tensor(src["attn"]["qkv"]["kernel"], dev))
            block.attn.out.copy_(_tensor(src["attn"]["out"]["kernel"], dev))
            block.mlp_in.copy_(_tensor(src["mlp_in"]["kernel"], dev))
            block.mlp_out.copy_(_tensor(src["mlp_out"]["kernel"], dev))
    return model


def _variables(tree: Mapping[str, Any]) -> Tuple[Mapping[str, Any], Mapping[str, Any]]:
    """(params, batch_stats) of a flax variable tree, with or without its
    collections' keys."""
    if "params" in tree:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def mlp_from_flax(variables: Mapping[str, Any], *, device=None) -> MLP:
    """The port's :class:`MLP` holding a flax ``MLP``'s variables
    (``Dense_i/kernel`` (in, out) and ``Dense_i/bias``), on ``device``."""
    p, _ = _variables(variables)
    names = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    kernels = [np.shape(p[k]["kernel"]) for k in names]
    dev = _torch_device(device)
    model = MLP(tuple(int(k[1]) for k in kernels), in_features=int(kernels[0][0]), device=dev)
    with torch.no_grad():
        for layer, name in zip(model.layers, names):
            layer.kernel.copy_(_tensor(p[name]["kernel"], dev))
            layer.bias.copy_(_tensor(p[name]["bias"], dev))
    return model


def _load_conv(conv, leaf, dev) -> None:
    conv.weight.copy_(_tensor(leaf["kernel"], dev).permute(3, 2, 0, 1))  # HWIO -> OIHW


def _load_norm(norm, leaf, stats, dev) -> None:
    norm.scale.copy_(_tensor(leaf["scale"], dev))
    norm.bias.copy_(_tensor(leaf["bias"], dev))
    if stats:
        norm.mean.copy_(_tensor(stats["mean"], dev))
        norm.var.copy_(_tensor(stats["var"], dev))


def resnet_from_flax(variables: Mapping[str, Any], *, stage_sizes, block_cls=None, device=None, **config) -> ResNet:
    """The port's :class:`ResNet` holding a flax ``ResNet``'s variables
    (``params`` and ``batch_stats``), on ``device``: HWIO kernels become
    OIHW, the Dense kernel stays (in, out).  ``stage_sizes``,
    ``block_cls`` (default: the tree's block names) and the other fields
    (``s2d_stem``, ``dtype``) are the flax module's; the widths
    (``num_filters``, ``num_classes``, the input channels) are read from the
    tree."""
    p, stats = _variables(variables)
    if block_cls is None:
        block_cls = BottleneckBlock if any(k.startswith("BottleneckBlock_") for k in p) else BasicBlock
    kh, kw, in_ch, filters = np.shape(p["conv_init"]["kernel"])
    dev = _torch_device(device)
    model = ResNet(stage_sizes, block_cls, num_classes=int(np.shape(p["Dense_0"]["kernel"])[1]),
                   num_filters=int(filters), in_channels=int(in_ch), device=dev, **config)
    with torch.no_grad():
        _load_conv(model.conv_init, p["conv_init"], dev)
        _load_norm(model.bn_init, p["bn_init"], stats.get("bn_init"), dev)
        for name, block in model.blocks.items():
            src, st = p[name], stats.get(name, {})
            for child, module in block.named_children():
                if child.startswith("Conv_") or child == "conv_proj":
                    _load_conv(module, src[child], dev)
                else:
                    _load_norm(module, src[child], st.get(child), dev)
        model.Dense_0.kernel.copy_(_tensor(p["Dense_0"]["kernel"], dev))
        model.Dense_0.bias.copy_(_tensor(p["Dense_0"]["bias"], dev))
    return model
