"""Distributed linear algebra (counterpart of heat_tpu/core/linalg/):
the basics and QR.  ``solver`` and ``svd`` are a later slice (ROADMAP
queue 1, item 10)."""

from .basics import *
from .qr import *
