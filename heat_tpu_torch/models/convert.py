"""Carry a flax TransformerLM's parameters into the port.

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

from typing import Any, Mapping

import numpy as np
import torch

from .transformer import TransformerLM, _torch_device

__all__ = ["transformer_from_flax"]


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
