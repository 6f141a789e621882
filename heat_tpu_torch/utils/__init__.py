"""Utilities (counterpart of heat_tpu/utils/): the data layer so far."""

from . import data

__all__ = ["data"]
