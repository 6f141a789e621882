"""Strict parsing of integer environment knobs (counterpart of
heat_tpu/core/envparse.py): unset or empty gives the default; anything else
must parse as an integer at least ``minimum`` or the caller gets a
``ValueError`` naming the variable, so a mistyped knob never falls back
silently."""

import os
from typing import Optional

__all__ = ["env_int"]


def env_int(name: str, default: int, minimum: int = 1, env: Optional[dict] = None) -> int:
    """The integer value of environment variable ``name`` (read from ``env``
    when given): ``default`` when unset or empty; a malformed value or one
    below ``minimum`` raises ``ValueError``."""
    raw = (os.environ if env is None else env).get(name, "").strip()
    if not raw:
        return int(default)
    try:
        val = int(raw)
        if val < minimum:
            raise ValueError
    except ValueError:
        raise ValueError(f"{name} must be an integer >= {minimum}, got {raw!r}") from None
    return val
