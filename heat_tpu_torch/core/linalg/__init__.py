"""Distributed linear algebra (counterpart of heat_tpu/core/linalg/):
the basics, QR and the iterative solvers.  ``svd`` is a later slice
(ROADMAP queue 1, item 10)."""

from .basics import *
from .qr import *
from .solver import *
