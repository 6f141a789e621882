"""Neural network layer (counterpart of heat_tpu/nn/).

``ht.nn.X`` falls through to ``torch.nn.X``, the port's substrate (the JAX
package's falls through to ``flax.linen``); ``ht.nn.functional`` holds
``linear`` and falls through to ``torch.nn.functional``.
"""

import torch.nn as _torch_nn

from . import functional
from .data_parallel import DataParallel, DataParallelMultiGPU

__all__ = ["DataParallel", "DataParallelMultiGPU", "functional"]


def __getattr__(name):
    try:
        return getattr(_torch_nn, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute {name!r}")
