"""heat_tpu_torch: heat_tpu on PyTorch and CUDA for an NVIDIA H100.

The port mirrors heat_tpu's layout and names module for module and keeps its
single-controller model: one process drives a mesh of shard positions, and a
DNDarray holds one torch tensor per position.  Every Pallas kernel of
heat_tpu becomes a hand-written CUDA kernel under ``csrc/``, wrapped in
:mod:`heat_tpu_torch.ops` beside its plain torch version.

Entry points run on the card (``gpu``, cuda:0) unless the caller asks for
the CPU (``device="cpu"`` or ``use_device("cpu")``); without a card they
raise.  The slices ported so far carry the KMeans path (factories, the split
DNDarray, elementwise ops and reductions, ``spatial.cdist``,
``cluster.KMeans``), the linear-algebra path (``linalg.matmul`` and its
basics, ``linalg.qr``), the Lasso path (``regression.Lasso``) and the
sparse Spectral path (``sparse``, ``graph``, ``linalg.lanczos``,
``cluster.Spectral``).
"""

from .core import *
from .core import (
    arithmetics,
    base,
    constants,
    devices,
    exponential,
    factories,
    linalg,
    manipulations,
    random,
    relational,
    sanitation,
    statistics,
    stride_tricks,
    types,
)
from . import parallel
from . import ops
from . import spatial
from . import sparse
from . import graph
from . import cluster
from . import regression

__version__ = "0.1.0"
