"""Trigonometric and hyperbolic functions (counterpart of
heat_tpu/core/trigonometrics.py).  Elementwise, shard by shard; integer and
bool input is cast to float32 first, as in the JAX package
(heat_tpu/core/_operations.py:167-183)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "arccos", "acos", "arccosh", "acosh", "arcsin", "asin", "arcsinh", "asinh",
    "arctan", "atan", "arctan2", "atan2", "arctanh", "atanh",
    "cos", "cosh", "deg2rad", "degrees", "rad2deg", "radians",
    "sin", "sinc", "sinh", "tan", "tanh",
]

def arccos(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arccos, x, out=out)

acos = arccos

def arccosh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arccosh, x, out=out)

acosh = arccosh

def arcsin(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arcsin, x, out=out)

asin = arcsin

def arcsinh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arcsinh, x, out=out)

asinh = arcsinh

def arctan(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arctan, x, out=out)

atan = arctan

def arctan2(x1, x2) -> DNDarray:
    """Elementwise arc tangent of x1/x2 in the correct quadrant."""
    return _operations._binary_op(_operations._promoted(torch.atan2, inexact=True), x1, x2)

atan2 = arctan2

def arctanh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.arctanh, x, out=out)

atanh = arctanh

def cos(x, out=None) -> DNDarray:
    return _operations._local_op(torch.cos, x, out=out)

def cosh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.cosh, x, out=out)

def deg2rad(x, out=None) -> DNDarray:
    return _operations._local_op(torch.deg2rad, x, out=out)

radians = deg2rad

def rad2deg(x, out=None) -> DNDarray:
    return _operations._local_op(torch.rad2deg, x, out=out)

degrees = rad2deg

def sin(x, out=None) -> DNDarray:
    return _operations._local_op(torch.sin, x, out=out)

def sinh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.sinh, x, out=out)

def tan(x, out=None) -> DNDarray:
    return _operations._local_op(torch.tan, x, out=out)

def sinc(x, out=None) -> DNDarray:
    """Normalised sinc sin(πx)/(πx), 1 at 0."""
    return _operations._local_op(torch.sinc, x, out=out)

def tanh(x, out=None) -> DNDarray:
    return _operations._local_op(torch.tanh, x, out=out)

# the fusion engine's op table (shape-preserving "elementwise" maps)
for _fn, _name in [
    (torch.sin, "sin"), (torch.cos, "cos"), (torch.tan, "tan"), (torch.sinh, "sinh"), (torch.cosh, "cosh"),
    (torch.tanh, "tanh"), (torch.arcsin, "arcsin"), (torch.arccos, "arccos"), (torch.arctan, "arctan"),
    (torch.arcsinh, "arcsinh"), (torch.arccosh, "arccosh"), (torch.arctanh, "arctanh"),
    (torch.deg2rad, "deg2rad"), (torch.rad2deg, "rad2deg"), (torch.sinc, "sinc"),
    (_operations._promoted(torch.atan2, inexact=True), "arctan2"),
]:
    _operations.fusion.register_op(_fn, _name, kind="elementwise")
