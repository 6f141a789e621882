"""Simple MLP (counterpart of heat_tpu/models/mlp.py, the reference's MNIST
example net).

flax's ``nn.Dense`` infers its input width from the first call; so does the
port's :class:`MLP` when ``in_features`` is not given: its layers are made
by :meth:`MLP.init_parameters` from a sample input and an explicit
``torch.Generator`` (``nn.DataParallel.init`` calls it).  The initialisers
are flax's: kernels truncated-normal LeCun, biases zero.  Kernels keep
flax's (in, out) layout and are applied as ``x @ W + b``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .transformer import _lecun_normal_, _torch_device

__all__ = ["Dense", "MLP"]


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` with an (in, out) kernel."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = _torch_device(device)
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=dev))
        _lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(features, device=dev)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class MLP(nn.Module):
    """Fully connected classifier: ``features[:-1]`` hidden ReLU layers and
    an output layer, over the input flattened to (batch, -1)."""

    def __init__(self, features: Sequence[int] = (128, 64, 10), in_features: Optional[int] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self._device = _torch_device(device)
        self.layers = nn.ModuleList()
        if in_features is not None:
            self._build(int(in_features), generator)

    @property
    def needs_init(self) -> bool:
        """True until the layers exist (their input width is not known)."""
        return len(self.layers) == 0

    def _build(self, in_features: int, generator: Optional[torch.Generator]) -> None:
        widths = (in_features,) + self.features
        self.layers.extend(
            Dense(a, b, device=self._device, generator=generator) for a, b in zip(widths[:-1], widths[1:])
        )

    def init_parameters(self, sample_input: torch.Tensor, generator: Optional[torch.Generator] = None) -> "MLP":
        """Make the layers for inputs shaped like ``sample_input``."""
        if self.needs_init:
            sample = torch.as_tensor(sample_input)
            self._build(int(sample[0].numel()) if sample.ndim else 1, generator)
        return self

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.needs_init:
            raise RuntimeError("the MLP's input width is not known yet: call init_parameters(sample_input) first")
        x = torch.as_tensor(x, device=self.layers[0].kernel.device)
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)
