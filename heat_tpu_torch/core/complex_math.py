"""Complex number operations (counterpart of heat_tpu/core/complex_math.py).
Elementwise, shard by shard, with no cast of real input."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t: torch.Tensor, deg: bool) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float64)  # jnp.angle lifts integers to its default float
    a = torch.angle(t)
    return torch.rad2deg(a) if deg else a


def angle(x, deg: bool = False, out=None) -> DNDarray:
    """Phase angle, in degrees with ``deg``; 0 or π for real input."""
    return _operations._local_op(lambda t: _angle(t, deg), x, out=out, no_cast=True)


def _conj(t: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(t) if t.is_complex() else t


def conjugate(x, out=None) -> DNDarray:
    return _operations._local_op(_conj, x, out=out, no_cast=True)


conj = conjugate


def _imag(t: torch.Tensor) -> torch.Tensor:
    return t.imag.clone() if t.is_complex() else torch.zeros_like(t)


def imag(x, out=None) -> DNDarray:
    """Imaginary part; zeros of the input's type for real input."""
    return _operations._local_op(_imag, x, out=out, no_cast=True)


def _real(t: torch.Tensor) -> torch.Tensor:
    return t.real.clone() if t.is_complex() else t


def real(x, out=None) -> DNDarray:
    return _operations._local_op(_real, x, out=out, no_cast=True)


DNDarray.conj = lambda self, out=None: conjugate(self, out)
