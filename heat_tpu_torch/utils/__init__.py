"""Utilities (counterpart of heat_tpu/utils/): the data layer and
checkpointing."""

from . import checkpointing, data
from .checkpointing import Checkpointer, load_checkpoint, save_checkpoint

__all__ = ["Checkpointer", "checkpointing", "data", "load_checkpoint", "save_checkpoint"]
