"""Chunk sources and the rank-local slab read (counterpart of the first part
of heat_tpu/core/stream.py).

:func:`read_rows` is the one copy of the slab arithmetic: rows ``[lo, hi)``
of the split axis, every other axis whole, honouring the step of a user's
``slices`` (``base``).  Every HDF5, NetCDF, ``.npy`` and in-memory slab read
goes through it and, below it, through ``io._read_region``, the funnel the
tests spy on.  :func:`open_source` wraps a path or an array-like behind one
small handle (``shape``, ``np_dtype``, ``read(lo, hi)``, ``close``).

The rest of the JAX package's module (the prefetching pass, the residency
budget, the autotune and guard hooks) belongs to the runtime planes and is
not ported yet; ``stream`` is not exported at the top level.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["ChunkSource", "open_source", "read_rows"]


def read_rows(source, lo: int, hi: int, *, split_axis: int = 0, base: Optional[tuple] = None, copy: bool = False) -> np.ndarray:
    """Rows ``[lo, hi)`` of ``split_axis``, full extent elsewhere, as a host
    ndarray.  With ``base`` (one normalised slice per axis, as
    ``io._normalize_slices`` gives them) ``lo`` and ``hi`` count rows of
    ``base[split_axis]``, its step included.  ``copy=True`` forces a copy
    (views into a file's memory map must not outlive the file); a memory
    map read is always copied."""
    from . import io as ht_io  # io imports this module

    if base is None:
        sel = tuple(slice(lo, hi) if d == split_axis else slice(0, n) for d, n in enumerate(source.shape))
    else:
        bs = base[split_axis]
        step = 1 if bs.step is None else bs.step
        start = 0 if bs.start is None else bs.start
        sel = list(base)
        sel[split_axis] = slice(start + lo * step, start + hi * step, step)
        sel = tuple(sel)
    out = ht_io._read_region(source, sel)
    if copy or isinstance(source, np.memmap) or isinstance(out, np.memmap):
        out = np.array(out)
    return np.asarray(out)


class ChunkSource:
    """A row-sliceable host source: ``shape``, ``np_dtype``,
    ``read(lo, hi)`` gives rows ``[lo, hi)`` as a host ndarray, ``close()``
    (idempotent).  A context manager."""

    shape: Tuple[int, ...] = ()
    np_dtype: np.dtype = np.dtype(np.float32)

    def read(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "ChunkSource":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _cast(self, arr: np.ndarray) -> np.ndarray:
        return arr if arr.dtype == self.np_dtype else arr.astype(self.np_dtype)


class _ArraySource(ChunkSource):
    """An ndarray, a live h5py dataset, a memory map: anything with a
    ``shape`` and basic slicing."""

    def __init__(self, obj, np_dtype=None):
        self._obj = obj
        self.shape = tuple(obj.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else getattr(obj, "dtype", np.float32))

    def read(self, lo: int, hi: int) -> np.ndarray:
        return self._cast(read_rows(self._obj, lo, hi))


class _H5Source(ChunkSource):
    def __init__(self, path: str, dataset: str, np_dtype=None):
        import h5py

        self._handle = h5py.File(path, "r")
        try:
            self._dset = self._handle[dataset]
        except KeyError:
            self._handle.close()
            raise
        self.shape = tuple(self._dset.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else self._dset.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        return self._cast(read_rows(self._dset, lo, hi))

    def close(self) -> None:
        if self._handle is not None:
            self._handle.close()
            self._handle = None


class _NetCDFSource(ChunkSource):
    def __init__(self, path: str, variable: str, np_dtype=None):
        from . import io as ht_io

        self._handle = ht_io._netcdf_open(path)
        self._var = self._handle.variables[variable]
        self.shape = tuple(self._var.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else self._var.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        # scipy's classic-format reads are views into the file's memory map
        return self._cast(read_rows(self._var, lo, hi, copy=True))

    def close(self) -> None:
        if self._handle is None:
            return
        self._var = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self._handle.close()
        self._handle = None


def open_source(source, dataset: Optional[str] = None, *, np_dtype=None) -> ChunkSource:
    """A streamable row source: a path (``.h5``/``.hdf5`` and
    ``.nc``/``.nc4``/``.netcdf`` with ``dataset`` named, ``.npy`` memory
    mapped), an array-like with ``shape`` and ``__getitem__``, or an open
    :class:`ChunkSource`, returned as it is (its caller keeps it)."""
    if isinstance(source, ChunkSource):
        return source
    if isinstance(source, str):
        ext = os.path.splitext(source)[-1].lower().strip()
        if ext in (".h5", ".hdf5"):
            if dataset is None:
                raise ValueError("HDF5 sources need a dataset name")
            return _H5Source(source, dataset, np_dtype)
        if ext in (".nc", ".nc4", ".netcdf"):
            if dataset is None:
                raise ValueError("NetCDF sources need a variable name")
            return _NetCDFSource(source, dataset, np_dtype)
        if ext == ".npy":
            return _ArraySource(np.load(source, mmap_mode="r"), np_dtype)
        raise ValueError(f"unsupported streaming source extension {ext!r}")
    if hasattr(source, "shape") and hasattr(source, "__getitem__"):
        return _ArraySource(source, np_dtype)
    raise TypeError(f"cannot stream from {type(source)}")
