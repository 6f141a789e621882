"""Utilities (counterpart of heat_tpu/utils/): the synthetic data of the
cluster benchmark so far."""

from . import data

__all__ = ["data"]
