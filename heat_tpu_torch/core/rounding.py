"""Rounding, absolute value and clipping (counterpart of
heat_tpu/core/rounding.py).  Elementwise, shard by shard; ``ceil``,
``floor``, ``trunc``, ``fabs``, ``round`` and ``modf`` cast integer and
bool input to float32 first, ``abs``, ``clip`` and ``sign`` keep its
type, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, sanitation
from .dndarray import DNDarray

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "modf", "round", "sign", "sgn", "trunc"]


def _abs(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.bool else torch.abs(t)


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value; complex input gives its modulus."""
    result = _operations._local_op(_abs, x, out=out, no_cast=True)
    if dtype is not None:
        result = result.astype(dtype, copy=False)
    return result


absolute = abs


def ceil(x, out=None) -> DNDarray:
    return _operations._local_op(torch.ceil, x, out=out)


def _bound(v, like: torch.Tensor):
    if v is None:
        return None
    if isinstance(v, DNDarray):
        v = v.larray
    if np.isscalar(v):
        return torch.tensor(v, dtype=_operations._weak_type(like.dtype, v), device=like.device)
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v, device=like.device)


def _clip(t: torch.Tensor, lo, hi) -> torch.Tensor:
    # jnp.clip(t, lo, hi) = minimum(maximum(t, lo), hi) in the promoted type
    dt = t.dtype
    for b in (lo, hi):
        if b is not None:
            dt = torch.promote_types(dt, b.dtype)
    t = t.to(dt)
    if lo is not None:
        t = torch.maximum(t, lo.to(dt))
    if hi is not None:
        t = torch.minimum(t, hi.to(dt))
    return t


def clip(x, min=None, max=None, out=None) -> DNDarray:
    """Clamp values to [min, max]; either bound may be None, not both.  The
    result takes the type of x and the bounds (a Python float lifts an
    integer array to float64, as in the JAX package)."""
    if min is None and max is None:
        raise ValueError("either min or max must be given")
    sanitation.sanitize_in(x)
    ref = x.shards[0]
    lo, hi = _bound(min, ref), _bound(max, ref)
    return _operations._local_op(lambda t: _clip(t, lo, hi), x, out=out, no_cast=True)


def fabs(x, out=None) -> DNDarray:
    return _operations._local_op(torch.abs, x, out=out)


def floor(x, out=None) -> DNDarray:
    return _operations._local_op(torch.floor, x, out=out)


def modf(x, out=None):
    """Fractional and integral parts, each with the sign of x."""
    sanitation.sanitize_in(x)
    integral = _operations._local_op(torch.trunc, x)
    frac = _operations._local_op(lambda t: t - torch.trunc(t), x)
    if out is not None:
        sanitation.sanitize_out(out[0], frac)
        sanitation.sanitize_out(out[1], integral)
        return out
    return (frac, integral)


def _round(t: torch.Tensor, decimals: int) -> torch.Tensor:
    # jnp.round: half to even, at ``decimals`` places by a scale of 10**d
    if decimals == 0:
        return torch.round(t)
    scale = torch.tensor(10.0**decimals, dtype=t.dtype, device=t.device)
    return torch.round(t * scale) / scale


def round(x, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    result = _operations._local_op(lambda t: _round(t, decimals), x, out=out)
    if dtype is not None:
        result = result.astype(dtype, copy=False)
    return result


def _sign(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    if t.is_complex():
        # jnp.sign of a complex number: z / |z|, 0 at 0
        mag = torch.abs(t)
        return torch.where(mag == 0, torch.zeros_like(t), t / torch.where(mag == 0, torch.ones_like(mag), mag))
    # torch's sign of NaN is 0, jnp's NaN
    return torch.where(torch.isnan(t), t, torch.sign(t)) if t.is_floating_point() else torch.sign(t)


def sign(x, out=None) -> DNDarray:
    return _operations._local_op(_sign, x, out=out, no_cast=True)


sgn = sign


def trunc(x, out=None) -> DNDarray:
    return _operations._local_op(torch.trunc, x, out=out)


DNDarray.__abs__ = lambda self: abs(self)
DNDarray.clip = lambda self, min=None, max=None, out=None: clip(self, min, max, out)
DNDarray.round = lambda self, decimals=0, out=None, dtype=None: round(self, decimals, out, dtype)
DNDarray.modf = lambda self, out=None: modf(self, out)
