"""Random numbers (counterpart of heat_tpu/core/random.py): ``seed``,
``get_state``/``set_state``, ``rand`` (``random``, ``random_sample``,
``ranf``, ``sample``), ``randn`` (``standard_normal``), ``normal``,
``randint`` (``random_integer``), ``randperm``, ``permutation`` and
``shuffle_rows``.

The streams are ``heat_tpu.random``'s: the same seed, shape, dtype, split
and mesh give the same numbers (normal draws within a few ulp, see
:mod:`heat_tpu_torch.ops.threefry`).  The module keeps the JAX package's
``(seed, counter)`` state; draw number c uses the key
``fold_in(PRNGKey(seed), c)`` of jax's partitionable Threefry-2x32, and
element i of the draw hashes its flat index over the logical shape, so the
global array is the same at every mesh size.  The array is drawn whole at
its global shape by T1 (:func:`heat_tpu_torch.ops.threefry.threefry`, the
CUDA kernel on the card, its plain version on the CPU) and then cut into
shards.  The samplers follow ``jax.random``: ``uniform``'s mantissa bits,
``normal`` as ``sqrt(2) * erf_inv(u)`` (16-bit types drawn in f32 and
rounded), ``randint``'s two-draw span arithmetic (in the same kernel), and ``permutation``'s
rounds of sorting by fresh 32-bit keys.  A 16-bit array whose float32
draw would exceed ``_CHUNK_F32_BYTES`` is drawn in row blocks of key
``fold_in(key, block)`` at the rows the JAX package cuts
(heat_tpu/core/random.py:128).  ``randperm`` of a split-0 array over
several positions, ``shuffle_rows`` and ``permutation`` of distributed
rows take the JAX package's other route: sort keys from a keyed 8-round
Feistel bijection of the index (heat_tpu/core/random.py:304), so one seed
gives another permutation there than on one position, as in
``heat_tpu``.  Rows move once through the transport engine's take
(:func:`parallel.transport.tiled_take`).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .dndarray import DNDarray, _wrap
from ..ops import threefry as t1
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

#: the name of the generator in the state tuple
GENERATOR = "Threefry"

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
    """The generator's state as heat_tpu lays it out: ``("Threefry", seed,
    counter, 0, 0.0)``."""
    return (GENERATOR, _state.seed, _state.counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore a state from :func:`get_state` (the JAX package's too)."""
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state must be a tuple of length 3 or 5")
    if state[0] != GENERATOR:
        raise ValueError(f"unknown generator {state[0]!r}")
    _state.seed = int(state[1])
    _state.counter = int(state[2])


def _seed_key(value: int) -> t1.Key:
    """``jax.random.PRNGKey(value)`` outside jax's x64 mode, the TPU's: the
    seed's low 32 bits (a seed outside int32 keeps only those)."""
    return (0, int(value) & t1.MASK)


def _next_key() -> t1.Key:
    """``fold_in(PRNGKey(seed), counter)``; advances the counter."""
    key = t1.fold_in(_seed_key(_state.seed), _state.counter)
    _state.counter += 1
    return key


def _draw(kind: str, key: t1.Key, shape, tt: torch.dtype, tdev, params, out: Optional[torch.Tensor] = None):
    """One block of ``shape`` (written into ``out`` when given): flat
    counters from 0 under ``key``."""
    n = math.prod(shape)
    if not tt.is_complex:
        # 16-bit normals are drawn in f32 and rounded (T1 rounds as it writes)
        flat = t1.threefry(key, n, kind=kind, dtype=tt, bounds=params or None, device=tdev,
                           out=None if out is None else out.view(-1))
        return flat.reshape(shape)
    # jax's complex normal: two real draws of split keys, over sqrt(2)
    real = torch.float64 if tt == torch.complex128 else torch.float32
    re, im = (t1.threefry(t1.fold_in(key, j), n, kind="normal", dtype=real, device=tdev) for j in (0, 1))
    flat = torch.complex(re, im) / math.sqrt(2.0)
    if out is None:
        return flat.reshape(shape)
    out.copy_(flat.reshape(shape))
    return out


def _sample(kind: str, shape, tt: torch.dtype, tdev, params=()) -> torch.Tensor:
    """The draw of ``kind`` at the global ``shape`` under the next key;
    16-bit arrays past ``_CHUNK_F32_BYTES`` of f32 in the JAX package's row
    blocks, each written in place."""
    key = _next_key()
    count = math.prod(shape)
    if not shape or tt.itemsize >= 4 or 4 * count <= _CHUNK_F32_BYTES or shape[0] < 2:
        return _draw(kind, key, shape, tt, tdev, params)
    n_chunks = min(shape[0], -(-4 * count // _CHUNK_F32_BYTES))
    rows = -(-shape[0] // n_chunks)
    n_full, rem = divmod(shape[0], rows)
    out = torch.empty(shape, dtype=tt, device=tdev)
    for i in range(n_full + (1 if rem else 0)):
        lo = i * rows
        hi = min(lo + rows, shape[0])
        _draw(kind, t1.fold_in(key, i), (hi - lo,) + tuple(shape[1:]), tt, tdev, params, out=out[lo:hi])
    return out


def _shape_of(d) -> Tuple[int, ...]:
    return sanitize_shape(d[0] if len(d) == 1 and isinstance(d[0], (tuple, list)) else d)


def _floating(dtype) -> torch.dtype:
    tt = types.canonical_heat_type(dtype).torch_type()
    if not (tt.is_floating_point or tt.is_complex):
        raise TypeError(f"the sampler only accepts floating point dtypes, got {dtype}")
    return tt


def _array(kind: str, shape, tt, split, device, comm, params=()) -> DNDarray:
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    tensor = _sample(kind, shape, tt, device.torch_device, params)
    return _wrap(tensor, split if shape else None, device, comm)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1)."""
    tt = _floating(dtype)
    if tt.is_complex:
        raise TypeError(f"uniform only accepts real floating point dtypes, got {dtype}")
    return _array("uniform", _shape_of(d), tt, split, device, comm)


random = rand
random_sample = rand
ranf = rand
sample = rand


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    return _array("normal", _shape_of(d), _floating(dtype), split, device, comm)


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
    tt = types.canonical_heat_type(dtype).torch_type()
    if tt.is_floating_point or tt.is_complex or tt == torch.bool:
        raise TypeError(f"randint only accepts integer dtypes, got {dtype}")
    return _array("randint", sanitize_shape(size), tt, split, device, comm, (int(low), int(high)))


random_integer = randint


def _sort_perm(key: t1.Key, n: int, tdev) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ceil(3 ln n / ln(2^32 - 1))
    rounds, each a stable sort by fresh 32-bit keys of ``split(key)[1]``
    (ties keep the order of the previous round), the next round's key
    ``split(key)[0]``."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    perm = torch.arange(n, dtype=torch.int64, device=tdev)
    for _ in range(rounds):
        key, sub = t1.fold_in(key, 0), t1.fold_in(key, 1)
        sort_keys = t1.threefry(sub, n, kind="bits32", device=tdev).to(torch.int64) & t1.MASK
        perm = perm[torch.sort(sort_keys, stable=True).indices]
    return perm


def _feistel_perm(n: int, tdev) -> torch.Tensor:
    """The JAX package's sharded permutation (heat_tpu/core/random.py:304):
    round keys ``bits(next_key, (8,), uint32)``, a keyed 8-round Feistel
    bijection of each index over 32 bits as int32 sort keys (the sampler
    draws, and ignores, one key more), and the order that sorts them.  The
    keys are distinct, so any sort gives the same order."""
    rk = t1.bits32_values(_next_key(), 8)
    _next_key()
    # the halves are 16-bit: int32 holds them; a round's product needs int64
    i = torch.arange(n, dtype=torch.int64, device=tdev)
    left, right = (i >> 16).to(torch.int32), (i & 0xFFFF).to(torch.int32)
    del i
    for j in range(8):
        f = right.to(torch.int64).mul_(0x9E3779B9).bitwise_and_(t1.MASK).bitwise_xor_(rk[j])
        f = f.bitwise_right_shift_(13).bitwise_and_(0xFFFF).to(torch.int32)
        left, right = right, f.bitwise_xor_(left)
    # (left << 16) | right as int32 bits: left's top bit lands in the sign
    keys = left.bitwise_left_shift_(16).bitwise_or_(right)
    del left, right
    return torch.argsort(keys)


def _sharded_route(n: int, comm) -> bool:
    return comm.size > 1 and n >= comm.size


def randperm(n: int, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)``: with split 0 over several
    positions by the Feistel sort keys, else ``jax.random.permutation``'s
    rounds; the default dtype is int32, heat_tpu's outside its x64 mode."""
    comm = sanitize_comm(comm)
    dtype = types.int32 if dtype is None else types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    tdev = device.torch_device
    n = int(n)
    if split == 0 and _sharded_route(n, comm):
        perm = _feistel_perm(n, tdev)
    else:
        perm = _sort_perm(_next_key(), n, tdev)
    return _wrap(perm.to(dtype.torch_type()), split, device, comm)


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


def _rows_perm(lead: DNDarray, device=None) -> torch.Tensor:
    """The shared row order of ``shuffle_rows``: the Feistel route for
    distributed rows, else ``randperm(n)``'s."""
    n = lead.shape[0]
    tdev = lead.shards[0].device if device is None else devices.sanitize_device(device).torch_device
    if lead.is_distributed() and _sharded_route(n, lead.comm):
        return _feistel_perm(n, tdev)
    return _sort_perm(_next_key(), n, tdev)


def shuffle_rows(arrays, device=None) -> List[DNDarray]:
    """The rows of several split-0 arrays with the same leading extent,
    shuffled by one shared random permutation (the epoch shuffle of the
    data layer): rows stay paired across the arrays."""
    arrays = list(arrays)
    if not arrays:
        return []
    n = arrays[0].shape[0]
    if any(a.ndim == 0 or a.shape[0] != n or a.split != 0 for a in arrays):
        raise ValueError("shuffle_rows needs split=0 arrays with equal leading dim")
    perm = _rows_perm(arrays[0], device)
    return [_shuffled(a, perm) for a in arrays]


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """``randperm(x)`` for an int; otherwise ``x`` (a DNDarray, or
    array-like data placed with ``split``) with its rows in random
    order."""
    if isinstance(x, (int, np.integer)):
        return randperm(int(x), split=split, device=device, comm=comm)
    if isinstance(x, DNDarray) and x.split == 0 and x.ndim and x.is_distributed() and _sharded_route(x.shape[0], x.comm):
        return shuffle_rows([x], device=device)[0]
    key = _next_key()
    if not isinstance(x, DNDarray):
        from .factories import array

        x = array(x, split=split, device=device, comm=comm)
    if x.ndim == 0:
        raise ValueError("x must be an integer or at least 1-dimensional")
    return _shuffled(x, _sort_perm(key, x.shape[0], x.shards[0].device))
