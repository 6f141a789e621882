"""Utilities (counterpart of heat_tpu/utils/): the data layer,
checkpointing and the image transforms."""

from . import checkpointing, data, vision_transforms
from .checkpointing import Checkpointer, load_checkpoint, save_checkpoint

__all__ = ["Checkpointer", "checkpointing", "data", "load_checkpoint", "save_checkpoint", "vision_transforms"]
