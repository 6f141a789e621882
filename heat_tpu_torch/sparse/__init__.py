"""Distributed sparse matrices (counterpart of heat_tpu/sparse/)."""

from . import arithmetics, manipulations
from .arithmetics import add, mul
from .dcsr_matrix import DCSR_matrix
from .factories import sparse_csr_matrix
from .knn import knn_graph
from .manipulations import to_dense, todense
from .matmul import matmul, matvec_program

__all__ = [
    "DCSR_matrix",
    "add",
    "knn_graph",
    "matmul",
    "matvec_program",
    "mul",
    "sparse_csr_matrix",
    "to_dense",
    "todense",
]
