"""Packed bf16 samples (counterpart of heat_tpu/cluster/packing.py).

On the TPU a bf16 array whose minor dimension f is below 128 pads its lanes
to 128, so heat_tpu stores ``p = 128 // f`` samples in each 128-lane row:
the (n, f) samples as a ``(ceil(n/p), p*f)`` array, the slots past n zero.
The H100 has no lanes to pad.  What the port keeps is the layout's bytes:
``x2`` is row-major, so it is the same memory as the ``(ceil(n/p)*p, f)``
sample buffer with a zero tail, and every consumer reads the samples
through a view (:meth:`PackedSamples.sample_blocks`), never a relayout.
``p`` stays ``128 // f``, so the shapes and attributes are heat_tpu's.

:func:`randn_packed` and :func:`rand_packed` draw the packed shape directly
(through :mod:`heat_tpu_torch.core.random`, which draws large 16-bit arrays
in chunks: no full-size f32 intermediate); :func:`pack` copies an existing
(n, f) array into the layout; :func:`load_hdf5_packed` reads an HDF5
dataset straight into it, one block of whole packed rows a position.
``KMeans.fit``/``predict`` take a :class:`PackedSamples`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core import random as ht_random
from ..core import types
from ..core.dndarray import DNDarray, _wrap

__all__ = ["PackedSamples", "load_hdf5_packed", "pack", "packable", "rand_packed", "randn_packed"]


def packable(f: int, dtype) -> bool:
    """Packing applies iff the dtype is bf16 and f divides 128."""
    return types.canonical_heat_type(dtype) is types.bfloat16 and f < 128 and 128 % f == 0


class PackedSamples:
    """A logical (n, f) sample matrix stored as a ``(ceil(n/p), p*f)``
    DNDarray ``x2`` (``p = 128 // f``); the trailing slots of the last row
    are zero and no consumer reads them."""

    def __init__(self, x2: DNDarray, n: int, f: int):
        p = 128 // f
        expect_rows = -(-n // p)
        if tuple(x2.shape) != (expect_rows, p * f):
            raise ValueError(
                f"packed payload shape {x2.shape} does not match "
                f"n={n}, f={f} (expected {(expect_rows, p * f)})"
            )
        self.x2 = x2
        self.n = int(n)
        self.f = int(f)
        self.p = p

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.f)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.x2.dtype

    @property
    def split(self):
        return self.x2.split

    @property
    def comm(self):
        return self.x2.comm

    @property
    def device(self):
        return self.x2.device

    def sample_blocks(self) -> List[torch.Tensor]:
        """The samples as (count, f) views, one per position (one when
        ``x2`` is replicated): position r's packed rows, reshaped, up to
        sample n."""
        x2 = self.x2 if self.x2.split in (None, 0) else self.x2._resplit(0, exact=True)
        shards = x2.shards[:1] if x2.split is None else x2.shards
        blocks, start = [], 0
        for s in shards:
            count = max(0, min(self.n - start, s.shape[0] * self.p))
            blocks.append(s.reshape(-1, self.f)[:count])
            start += s.shape[0] * self.p
        return blocks

    def unpack(self) -> DNDarray:
        """The logical (n, f) array, replicated (a view of ``x2`` where it
        is one tensor)."""
        rows = self.x2.larray.reshape(-1, self.f)[: self.n]
        return _wrap(rows, None, self.device, self.comm)

    def __repr__(self) -> str:
        return f"PackedSamples(n={self.n}, f={self.f}, p={self.p}, dtype=ht.{self.dtype.__name__})"


def _zero_tail_(x2: DNDarray, n: int, p: int) -> None:
    """Zero the slots of the last row past sample n, in place (slot s of
    row r is sample r*p + s; heat_tpu's ``_zero_tail``)."""
    rows, pf = x2.shape
    keep = (n - (rows - 1) * p) * (pf // p)
    shards = x2.shards[:1] if x2.split is None else x2.shards
    for r, s in enumerate(shards):
        if s.numel() == 0:
            continue
        off = 0 if x2.split is None else x2.comm.chunk(tuple(x2.shape), x2.split, rank=r)[0]
        if x2.split == 1:
            s[-1, max(keep - off, 0) :] = 0
        elif off + s.shape[0] == rows:
            s[-1, keep:] = 0


def _packed_factory(sampler, n: int, f: int, dtype, split, device, comm) -> PackedSamples:
    if not packable(f, dtype):
        raise ValueError(
            f"lane packing needs bf16 and f | 128, got f={f}, "
            f"dtype={types.canonical_heat_type(dtype).__name__}"
        )
    p = 128 // f
    rows = -(-n // p)
    x2 = sampler(rows, p * f, dtype=dtype, split=split, device=device, comm=comm)
    if n % p:
        _zero_tail_(x2, n, p)
    return PackedSamples(x2, n, f)


def randn_packed(n: int, f: int, dtype=types.bfloat16, split: Optional[int] = 0, device=None, comm=None) -> PackedSamples:
    """Standard-normal samples drawn directly in the packed shape (the
    ingest path of the 1e8 x 64 bf16 north star)."""
    return _packed_factory(ht_random.randn, n, f, dtype, split, device, comm)


def rand_packed(n: int, f: int, dtype=types.bfloat16, split: Optional[int] = 0, device=None, comm=None) -> PackedSamples:
    """Uniform [0, 1) samples in the packed shape (see :func:`randn_packed`)."""
    return _packed_factory(ht_random.rand, n, f, dtype, split, device, comm)


def pack(x: DNDarray) -> PackedSamples:
    """An existing (n, f) bf16 array in the packed layout: a view of its
    samples when n is a multiple of p and they are one tensor, else a copy
    into a buffer with a zero tail."""
    n, f = x.shape
    if not packable(f, x.dtype):
        raise ValueError(f"cannot lane-pack f={f}, dtype={x.dtype.__name__}")
    p = 128 // f
    rows = -(-n // p)
    flat = x.larray
    if n % p == 0:
        x2 = flat.reshape(rows, p * f)
    else:
        buf = torch.zeros((rows * p, f), dtype=flat.dtype, device=flat.device)
        buf[:n] = flat
        x2 = buf.view(rows, p * f)
    return PackedSamples(_wrap(x2, x.split, x.device, x.comm), n, f)


def load_hdf5_packed(path: str, dataset: str, dtype=types.bfloat16, device=None, comm=None, split: Optional[int] = 0) -> PackedSamples:
    """A sharded HDF5 load of an (n, f) dataset straight into the packed
    layout: each position's packed rows [lo, hi) are the samples [lo·p,
    min(hi·p, n)), read as one slab, zero-filled to whole rows and placed
    on its device in ``dtype``; no (n, f) copy exists."""
    import numpy as np

    from ..core import io as ht_io
    from ..core import stream
    from ..core.devices import sanitize_device
    from ..parallel.mesh import sanitize_comm

    if split != 0:
        raise ValueError("packed loads are row-sharded: split must be 0")
    with stream.open_source(path, dataset=dataset) as src:
        n, f = src.shape
        if not packable(f, dtype):
            raise ValueError(f"cannot lane-pack f={f}, dtype={types.canonical_heat_type(dtype).__name__}")
        p = 128 // f
        rows = -(-n // p)

        def read_packed_slab(lo: int, hi: int) -> np.ndarray:
            chunk = src.read(lo * p, min(hi * p, n))
            short = (hi - lo) * p - chunk.shape[0]
            if short:  # the last row's slots past sample n
                chunk = np.concatenate([chunk, np.zeros((short, f), chunk.dtype)])
            return chunk.reshape(hi - lo, p * f)

        x2 = ht_io._assemble_sharded(read_packed_slab, (rows, p * f), dtype, 0, sanitize_device(device), sanitize_comm(comm))
    return PackedSamples(x2, n, f)
