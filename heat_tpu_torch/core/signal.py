"""Signal processing (counterpart of heat_tpu/core/signal.py): ``convolve``.

The JAX package expresses the 1-D convolution of a split array as one
global ``conv_general_dilated`` and lets XLA's partitioner fetch the halos.
Here each position computes its own chunk of the output, cut by the chunk
rule for the output's length, from the input rows that chunk needs: its
shard's rows and halos of up to ``len(v) - 1`` rows read from the
neighbouring shards (zeros beyond the array's ends).  So the output is
born in its final layout and nothing is re-cut or gathered.  The local
product is ``torch.nn.functional.conv1d`` with cuDNN deterministic and
TF32 off: float32 stays IEEE float32, and reruns are bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray
from ..parallel import transport

__all__ = ["convolve"]

# bytes the last convolve read from other positions' shards
last_halo_bytes = 0


def convolve(a: DNDarray, v, mode: str = "full") -> DNDarray:
    """Discrete linear convolution of the 1-D ``a`` with the 1-D ``v``
    (heat_tpu/core/signal.py:21) in mode ``full`` (length n + k − 1),
    ``same`` (n, centred left-heavy for an even k) or ``valid`` (n − k + 1,
    empty where the filter is longer than ``a``).
    Integer inputs are convolved in float32 and rounded back; the result is
    split as ``a``.  :data:`last_halo_bytes` is what the call read from
    other positions' shards."""
    global last_halo_bytes
    sanitation.sanitize_in(a)
    if isinstance(v, DNDarray):
        kernel = v.larray
    else:
        kernel = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if a.ndim != 1 or kernel.ndim != 1:
        raise ValueError("convolve only supports 1-D inputs")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unsupported mode {mode!r}")
    promoted = types.promote_types(a.dtype, types.canonical_heat_type(kernel.dtype))
    tt = promoted.torch_type()
    compute = tt if (tt.is_floating_point or tt.is_complex) else torch.float32
    n, k = a.shape[0], kernel.shape[0]
    shift = {"full": 0, "same": (k - 1) // 2, "valid": k - 1}[mode]
    length = {"full": n + k - 1, "same": n, "valid": n - k + 1}[mode]
    comm = a.comm
    split = a.split
    if length < 0:
        # the JAX package's unpadded convolution of a filter longer than
        # the signal is empty; numpy would swap the two inputs instead
        empty = a.shards[0].new_empty(0, dtype=tt)
        return DNDarray([empty] * comm.size, (0,), promoted, split, a.device, comm)
    shards = a.shards if split is not None else a.shards[:1]
    src = transport.RowSource(0, n, shards=shards)
    w = kernel.to(device=shards[0].device, dtype=compute).flip(0).reshape(1, 1, k)
    outs, halo = [], 0
    for r, (o0, o1) in enumerate(transport._bounds(length, len(shards))):
        # output o is full[o + shift], which reads a[o + shift - k + 1 .. o + shift]
        if o1 == o0:
            outs.append(w.new_zeros(0).to(tt))
            continue
        lo, hi = o0 + shift - k + 1, o1 + shift
        x, y = max(lo, 0), max(min(hi, n), lo, 0)
        own = src.bounds[r]
        halo += (y - x - max(min(y, own[1]) - max(x, own[0]), 0)) * shards[0].element_size()
        win = torch.nn.functional.pad(src.range(x, y).to(compute), (x - lo, hi - y))
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            out = torch.nn.functional.conv1d(win.reshape(1, 1, -1), w)[0, 0]
        if compute is not tt:
            out = torch.round(out).to(tt)
        outs.append(out)
    last_halo_bytes = halo if split is not None else 0
    if split is None:
        outs = outs * comm.size
    return DNDarray(outs, (length,), types.canonical_heat_type(outs[0].dtype), split, a.device, comm)
