"""Sparse elementwise arithmetic (counterpart of heat_tpu/sparse/arithmetics.py)."""

from __future__ import annotations

from ._operations import _binary_op_csr
from .dcsr_matrix import DCSR_matrix

__all__ = ["add", "mul"]


def add(t1: DCSR_matrix, t2: DCSR_matrix) -> DCSR_matrix:
    """Elementwise sparse addition: the union of the two patterns."""
    return _binary_op_csr("add", t1, t2)


def mul(t1: DCSR_matrix, t2: DCSR_matrix) -> DCSR_matrix:
    """Elementwise (Hadamard) sparse product: the intersection of the two
    patterns."""
    return _binary_op_csr("mul", t1, t2)
