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

__all__ = ["e", "inf", "nan", "pi", "E", "INF", "NAN", "NINF", "PI"]
