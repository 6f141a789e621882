"""Mathematical constants (counterpart of heat_tpu/core/constants.py)."""

import math

INF = float("inf")
NAN = float("nan")
NINF = -float("inf")
PI = math.pi
E = math.e

inf = INF
nan = NAN
pi = PI
e = E

Euler = E
Inf = INF
Infty = INF
Infinity = INF
NaN = NAN

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi", "E", "INF", "NAN", "NINF", "PI"]
