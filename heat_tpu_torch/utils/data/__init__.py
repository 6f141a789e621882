"""Data utilities (counterpart of heat_tpu/utils/data/)."""

from . import spherical
from .spherical import create_spherical_dataset

__all__ = ["create_spherical_dataset", "spherical"]
