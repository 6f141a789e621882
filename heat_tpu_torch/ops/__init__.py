"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

Ported so far: K1, the fused squared-distance kernel (:mod:`.cdist`).
"""

from . import cdist

__all__ = ["cdist"]
