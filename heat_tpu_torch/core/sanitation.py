"""Input validation (counterpart of heat_tpu/core/sanitation.py)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["sanitize_in", "sanitize_out"]


def sanitize_in(x) -> None:
    """Raise unless ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, got {type(x)}")


def sanitize_out(out, result: DNDarray) -> DNDarray:
    """Write ``result`` into the ``out=`` target (heat_tpu/core/sanitation.py:44):
    ``out`` must be a DNDarray of the result's shape; it takes the result's
    values, cast to its own dtype, and the result's split.  Returns ``out``."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, got {type(out)}")
    if tuple(out.shape) != tuple(result.shape):
        raise ValueError(f"expected out shape {tuple(result.shape)}, got {tuple(out.shape)}")
    return out._adopt(result)
