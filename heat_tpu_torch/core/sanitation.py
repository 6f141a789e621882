"""Input validation (counterpart of heat_tpu/core/sanitation.py)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["sanitize_in"]


def sanitize_in(x) -> None:
    """Raise unless ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, got {type(x)}")

