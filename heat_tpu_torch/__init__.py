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
``cluster.Spectral``), the TransformerLM forward (``models``,
``parallel.sequence``, ``ops.flash_attention``), the
``ops.pallas_matmul`` entry point, and the transport engine under every
layout change (``reshape`` across the split, ``resplit``, advanced
indexing, the other manipulations and ``sort``; ``parallel.transport``,
``parallel.select``, ``parallel.sort``, ``ops.repack``), and files to the
card and back (``io``, ``load``/``save`` and the format functions,
``native``, ``datasets``, ``utils.data``), random numbers on
``heat_tpu``'s Threefry streams (``random``, ``ops.threefry``), and
data-parallel training (``nn``, ``optim``, ``models``,
``utils.checkpointing``).
"""

from .core import *
from .core import (
    arithmetics,
    base,
    complex_math,
    constants,
    devices,
    exponential,
    factories,
    io,
    linalg,
    logical,
    manipulations,
    random,
    relational,
    rounding,
    sanitation,
    signal,
    statistics,
    stride_tricks,
    tiling,
    trigonometrics,
    types,
    version,
)
from .core.version import __version__
from . import parallel
from . import ops
from . import spatial
from . import sparse
from . import graph
from . import classification
from . import cluster
from . import regression
from . import models
from . import nn
from . import optim
from . import naive_bayes
from . import utils
from . import datasets
from . import native
