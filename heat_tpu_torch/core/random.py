"""Random numbers (counterpart of heat_tpu/core/random.py): ``seed``,
``get_state``/``set_state``, ``rand`` (``random``, ``random_sample``,
``ranf``, ``sample``), ``randn`` (``standard_normal``), ``normal``,
``randint`` (``random_integer``), ``randperm``, ``permutation`` and
``shuffle_rows``.

The module keeps the JAX package's stateful ``(seed, counter)`` facade.  Each
draw seeds a fresh ``torch.Generator`` on the target device from that pair,
generates the whole array at its global shape and then cuts it into shards,
so one seed gives the same global numbers at every mesh size.  A
permutation of split rows (``permutation``, ``shuffle_rows``) draws one
``randperm`` the same way and moves each row once through the transport
engine's take (:func:`parallel.transport.tiled_take`), with the
permutation as the row list.  A 16-bit
array whose float32 draw would exceed ``_CHUNK_F32_BYTES`` is drawn in
chunks of that size into its own buffer (the JAX package's chunked block
sampler, heat_tpu/core/random.py:128), so no full-size f32 intermediate
exists.  The numbers differ from ``jax.random``'s Threefry streams: bit
parity is ROADMAP item 9.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .dndarray import DNDarray, _wrap
from ..parallel import transport
from ..parallel.mesh import sanitize_comm
from .stride_tricks import sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random",
    "random_integer",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "shuffle_rows",
    "standard_normal",
]

#: the name of the port's generator in the state tuple
GENERATOR = "Philox"

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


def get_state() -> Tuple[str, int, int, int, float]:
    """The generator's state as heat_tpu lays it out: ``(name, seed,
    counter, 0, 0.0)``; the name is the port's generator, ``"Philox"``."""
    return (GENERATOR, _state.seed, _state.counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore a state from :func:`get_state`.  A ``"Threefry"`` state (the
    JAX package's) is refused rather than read as a Philox one: its
    streams are other numbers (bit parity is a later item)."""
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state must be a tuple of length 3 or 5")
    if state[0] == "Threefry":
        raise ValueError("a Threefry state cannot be restored: the port draws from Philox streams")
    if state[0] != GENERATOR:
        raise ValueError(f"unknown generator {state[0]!r}")
    _state.seed = int(state[1])
    _state.counter = int(state[2])


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


random = rand
random_sample = rand
ranf = rand
sample = rand


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    return _sample("normal", d, dtype, split, device, comm)


standard_normal = randn


def _operand(v, like: DNDarray):
    """``v`` (a scalar, or a DNDarray broadcasting against ``like``) per
    position of ``like``: its own shard where it is split like ``like``."""
    if not isinstance(v, DNDarray):
        return [v] * like.comm.size
    if v.shape == like.shape and v.split == like.split and v.comm.size == like.comm.size:
        return v.shards
    whole = v.larray
    if like.split is None or whole.ndim < like.ndim - like.split:
        return [whole] * like.comm.size
    ax = like.split - (like.ndim - whole.ndim)
    if whole.shape[ax] == 1:
        return [whole] * like.comm.size
    return [whole.narrow(ax, like.comm.chunk(like.shape, like.split, rank=r)[0], s.shape[like.split])
            for r, s in enumerate(like.shards)]


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples ``mean + std * randn(shape)``; ``mean`` and ``std``
    may be DNDarrays that broadcast against ``shape``.  The result keeps
    the draw's dtype."""
    if shape is None:
        shape = ()
    base = randn(*((shape,) if isinstance(shape, (tuple, list)) else (shape,)), dtype=dtype, split=split,
                 device=device, comm=comm)
    tt = base.dtype.torch_type()
    parts = list(zip(base.shards, _operand(mean, base), _operand(std, base)))
    shards = [(s * sd + m).to(tt) for s, m, sd in (parts if base.split is not None else parts[:1])]
    if base.split is None:
        shards = shards * base.comm.size
    return DNDarray(shards, base.shape, base.dtype, base.split, base.device, base.comm)


def randint(low, high=None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform integers in [low, high) (``high`` None: [0, low)).  The
    bounds are python ints, so uint8's ``high=256`` and negative ``low``
    for signed types work."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = ()
    shape = sanitize_shape(size)
    device = devices.sanitize_device(device)
    tdev = device.torch_device
    tt = types.canonical_heat_type(dtype).torch_type()
    tensor = torch.randint(int(low), int(high), shape, generator=_next_generator(tdev), dtype=tt, device=tdev)
    return _wrap(tensor, split if shape else None, device, sanitize_comm(comm))


random_integer = randint


def _perm(n: int, tdev) -> torch.Tensor:
    return torch.randperm(int(n), generator=_next_generator(tdev), dtype=torch.int64, device=tdev)


def randperm(n: int, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)``, the same at every mesh size;
    the default dtype is int32, heat_tpu's outside its x64 mode."""
    dtype = types.int32 if dtype is None else types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    perm = _perm(n, device.torch_device).to(dtype.torch_type())
    return _wrap(perm, split, device, sanitize_comm(comm))


def _shuffled(a: DNDarray, perm: torch.Tensor) -> DNDarray:
    """``a``'s rows in the order ``perm``: along a split axis 0 through the
    transport engine's take, else each shard's own rows."""
    if a.split == 0 and a.is_distributed():
        shards = transport.tiled_take(a.shards, perm, a.shape[0], 0, a.comm)
    elif a.split is None:
        shards = [a.shards[0].index_select(0, perm.to(a.shards[0].device))] * a.comm.size
    else:
        shards = [s.index_select(0, perm.to(s.device)) for s in a.shards]
    return DNDarray(shards, a.shape, a.dtype, a.split, a.device, a.comm)


def shuffle_rows(arrays, device=None):
    """The rows of several split-0 arrays with the same leading extent,
    shuffled by one shared random permutation (the epoch shuffle of the
    data layer): rows stay paired across the arrays."""
    arrays = list(arrays)
    if not arrays:
        return []
    n = arrays[0].shape[0]
    if any(a.ndim == 0 or a.shape[0] != n or a.split != 0 for a in arrays):
        raise ValueError("shuffle_rows needs split=0 arrays with equal leading dim")
    perm = _perm(n, arrays[0].shards[0].device)
    return [_shuffled(a, perm) for a in arrays]


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """``randperm(x)`` for an int; otherwise ``x`` (a DNDarray, or
    array-like data placed with ``split``) with its rows in random
    order."""
    if isinstance(x, (int, np.integer)):
        return randperm(int(x), split=split, device=device, comm=comm)
    if not isinstance(x, DNDarray):
        from .factories import array

        x = array(x, split=split, device=device, comm=comm)
    if x.ndim == 0:
        raise ValueError("x must be an integer or at least 1-dimensional")
    return _shuffled(x, _perm(x.shape[0], x.shards[0].device))
