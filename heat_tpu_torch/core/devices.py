"""Device handling (counterpart of heat_tpu/core/devices.py).

``cpu`` always exists; ``gpu`` names the first CUDA card and is the default
device.  Whether a card exists is asked when a tensor is about to be placed
(:attr:`Device.torch_device`), never at import: without a card, an entry
point that was not asked for the CPU raises instead of running there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "sanitize_device", "use_device"]


class Device:
    """A device backend on which arrays live: ``"cpu"`` or ``"gpu"``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.__device_type = device_type
        self.__device_id = device_id

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return self.__device_id

    @property
    def torch_device(self) -> torch.device:
        """The torch device tensors of this backend are placed on.  Raises
        for ``gpu`` when no CUDA card is present."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' or call "
                "heat_tpu_torch.use_device('cpu') to run on the CPU"
            )
        return torch.device("cuda", self.__device_id)

    def __repr__(self) -> str:
        return f"device({str(self)!r})"

    def __str__(self) -> str:
        return f"{self.__device_type}:{self.__device_id}"

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        if isinstance(other, str):
            try:
                return self == sanitize_device(other)
            except (ValueError, TypeError):
                return False
        return NotImplemented

    def __hash__(self):
        return hash(str(self))


cpu = Device("cpu")
"""The host CPU."""

gpu = Device("gpu")
"""The first CUDA card (cuda:0)."""

__default_device: Device = gpu


def get_device() -> Device:
    """The current default device."""
    return __default_device


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Normalize a device argument; ``None`` is the default device."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        device = "gpu" if device.type == "cuda" else device.type
    if isinstance(device, str):
        name, _, ordinal = device.partition(":")
        name = name.strip().lower()
        if name == "cpu":
            return cpu
        if name in ("gpu", "cuda"):
            return gpu if not ordinal else Device("gpu", int(ordinal))
        raise ValueError(f"unknown device {device!r}")
    raise TypeError(f"device must be None, str or Device, got {type(device)}")


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the process-global default device."""
    global __default_device
    __default_device = sanitize_device(device)
