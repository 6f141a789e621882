"""Distributed linear algebra (counterpart of heat_tpu/core/linalg/):
the basics, QR, SVD and the iterative solvers."""

from .basics import *
from .qr import *
from .solver import *
from .svd import *
