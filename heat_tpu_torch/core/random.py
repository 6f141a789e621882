"""Random numbers (counterpart of heat_tpu/core/random.py): ``seed``,
``rand`` and ``randn``.

The module keeps the JAX package's stateful ``(seed, counter)`` facade.  Each
draw seeds a fresh ``torch.Generator`` on the target device from that pair,
generates the whole array at its global shape and then cuts it into shards,
so one seed gives the same global numbers at every mesh size.  A 16-bit
array whose float32 draw would exceed ``_CHUNK_F32_BYTES`` is drawn in
chunks of that size into its own buffer (the JAX package's chunked block
sampler, heat_tpu/core/random.py:128), so no full-size f32 intermediate
exists.  The numbers differ from ``jax.random``'s Threefry streams: bit
parity is ROADMAP item 9.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from . import devices, types
from .dndarray import DNDarray, _wrap
from ..parallel.mesh import sanitize_comm
from .stride_tricks import sanitize_shape

__all__ = ["rand", "randn", "seed"]

#: the largest float32 draw a 16-bit array is made from at once (2 GiB, as
#: in the JAX package)
_CHUNK_F32_BYTES = 2 << 30


class _State:
    """The global ``(seed, counter)`` pair."""

    def __init__(self):
        self.seed = int(time.time() * 256) % (2**31)
        self.counter = 0


_state = _State()


def seed(new_seed: Optional[int] = None) -> None:
    """Re-seed the generator and reset its counter."""
    if new_seed is None:
        new_seed = int(time.time() * 256) % (2**31)
    _state.seed = int(new_seed)
    _state.counter = 0


def _next_generator(tdev: torch.device) -> torch.Generator:
    """A generator on ``tdev`` for the next draw; advances the counter."""
    gen = torch.Generator(device=tdev)
    # the pair folds into one 63-bit seed: distinct counters, distinct streams
    gen.manual_seed((_state.seed * 1_000_003 + _state.counter) % (2**63 - 1))
    _state.counter += 1
    return gen


def _sample(kind: str, d, dtype, split, device, comm) -> DNDarray:
    shape = d[0] if len(d) == 1 and isinstance(d[0], (tuple, list)) else d
    shape = sanitize_shape(shape)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    tdev = device.torch_device
    gen = _next_generator(tdev)
    tt = types.canonical_heat_type(dtype).torch_type()
    draw = torch.rand if kind == "uniform" else torch.randn
    # 16-bit types sample in float32 and round: a direct half-precision
    # normal transform is biased
    count = math.prod(shape)
    if tt.itemsize < 4 and 4 * count > _CHUNK_F32_BYTES:
        tensor = torch.empty(shape, dtype=tt, device=tdev)
        flat, step = tensor.view(-1), _CHUNK_F32_BYTES // 4
        for lo in range(0, count, step):
            flat[lo : lo + step] = draw(min(step, count - lo), generator=gen, dtype=torch.float32, device=tdev)
    else:
        tensor = draw(shape, generator=gen, dtype=torch.float32, device=tdev).to(tt)
    return _wrap(tensor, split if shape else None, device, comm)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1)."""
    return _sample("uniform", d, dtype, split, device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    return _sample("normal", d, dtype, split, device, comm)
