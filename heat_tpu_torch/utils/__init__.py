"""Utilities (counterpart of heat_tpu/utils/): the data layer,
checkpointing, fault injection and elastic training, the monitoring
harness, chain-delta timing and the image transforms."""

from . import checkpointing, data, fault, monitor, vision_transforms
from .checkpointing import Checkpointer, load_checkpoint, save_checkpoint
from .fault import ElasticFailure, FaultInjector, StallDetector, run_elastic

__all__ = [
    "Checkpointer",
    "ElasticFailure",
    "FaultInjector",
    "StallDetector",
    "checkpointing",
    "data",
    "fault",
    "load_checkpoint",
    "monitor",
    "run_elastic",
    "save_checkpoint",
    "vision_transforms",
]
