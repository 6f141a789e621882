"""Parallel I/O (counterpart of heat_tpu/core/io.py).

``load``/``save`` dispatch on the file's extension to HDF5, NetCDF, CSV and
``.npy``/``.npz``.  With ``split`` given, a load reads one slab a position
(the chunk rule's rows of the split axis) through one funnel,
:func:`_read_region`, casts it and moves it to that position's device: the
global array never exists on the host.  A save copies one position's shard
to the host at a time and writes it through :func:`_write_region`.  The
port's shards carry no padding, so a slab is exactly its position's rows.

NetCDF goes through netCDF4 where it is installed, else through scipy's
reader and writer of the classic format.  CSV files of float32 go through
the native parser (``heat_tpu_torch.native``, built by g++ at first use),
every other type through numpy's.
"""

from __future__ import annotations

import io as _pyio
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from . import devices, types
from .dndarray import DNDarray, _host, _wrap
from ..parallel.mesh import sanitize_comm

__all__ = [
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "load_npy",
    "save",
    "save_csv",
    "save_hdf5",
    "save_netcdf",
    "save_npy",
    "supports_hdf5",
    "supports_netcdf",
]

try:
    import h5py
except ImportError:
    h5py = None

try:
    import netCDF4
except ImportError:
    netCDF4 = None

try:
    from scipy.io import netcdf_file as _scipy_netcdf
except ImportError:
    _scipy_netcdf = None


def supports_hdf5() -> bool:
    """True iff h5py is importable."""
    return h5py is not None


def supports_netcdf() -> bool:
    """True iff a NetCDF backend is importable: netCDF4, else scipy's
    classic-format reader."""
    return netCDF4 is not None or _scipy_netcdf is not None


def _read_region(source, sel) -> np.ndarray:
    """Every slab read goes through here (the tests spy on it: no call
    reads more than one position's slab)."""
    return np.asarray(source[sel])


def _write_region(sink, sel, value: np.ndarray) -> None:
    """Every slab write goes through here."""
    sink[sel] = value


def _stream():
    """``core.stream``, imported at first use: ``stream`` is not a
    top-level name of the package until the rest of it is ported."""
    from . import stream

    return stream


def _netcdf_open(path: str):
    """A NetCDF file open for reading: netCDF4's, else scipy's (memory
    mapped, so slab reads stay lazy)."""
    if netCDF4 is not None:
        return netCDF4.Dataset(path, "r")
    if _scipy_netcdf is not None:
        return _scipy_netcdf(path, "r", mmap=True)
    raise RuntimeError("no NetCDF backend (netCDF4 or scipy) is available")


def _host_dtype(dtype) -> np.dtype:
    """The numpy type a slab of heat type ``dtype`` is read as: its own, or
    float32 for bfloat16 (numpy has none; torch rounds the slab)."""
    tt = types.canonical_heat_type(dtype).torch_type()
    return np.dtype(np.float32) if tt == torch.bfloat16 else torch.empty(0, dtype=tt).numpy().dtype


def _to_device(slab: np.ndarray, dtype, device: devices.Device) -> torch.Tensor:
    """A host slab as a tensor of heat type ``dtype`` on ``device``: cast on
    the host only where numpy must (another byte order, another type), so
    a slab already of the type moves once and is never copied on the host."""
    hd = _host_dtype(dtype)
    if slab.dtype != hd:
        slab = slab.astype(hd)
    if not slab.flags.c_contiguous:
        slab = np.ascontiguousarray(slab)
    tt = types.canonical_heat_type(dtype).torch_type()
    return torch.from_numpy(slab).to(device=device.torch_device, dtype=tt)


def _place(arr: np.ndarray, dtype, split, device, comm) -> DNDarray:
    """A whole host array as a DNDarray (``dtype`` None: its own type)."""
    dtype = types.canonical_heat_type(arr.dtype if dtype is None else dtype)
    device = devices.sanitize_device(device)
    return _wrap(_to_device(arr, dtype, device), split, device, comm)


def _assemble_sharded(read_slab: Callable[[int, int], np.ndarray], gshape, dtype, split: int, device, comm) -> DNDarray:
    """A split DNDarray from one slab a position: ``read_slab(lo, hi)``
    gives the rows [lo, hi) of the split axis (every other axis whole),
    which go to the position's device before the next slab is read."""
    device = devices.sanitize_device(device)
    dtype = types.canonical_heat_type(dtype)
    gshape = tuple(int(s) for s in gshape)
    shards = []
    for r in range(comm.size):
        lo, lshape, _ = comm.chunk(gshape, split, rank=r)
        shards.append(_to_device(read_slab(lo, lo + lshape[split]), dtype, device))
    return DNDarray(shards, gshape, dtype, split, device, comm)


def _iter_shard_slabs(data: DNDarray):
    """``(slices, host slab)`` for each position with rows, in position
    order, one host copy at a time."""
    for r, shard in enumerate(data.shards):
        _, lshape, slices = data.comm.chunk(data.shape, data.split, rank=r)
        if lshape[data.split]:
            yield slices, _host(shard)


def _save_dtype(data: DNDarray) -> np.dtype:
    return _host(torch.empty(0, dtype=data.dtype.torch_type())).dtype


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by the file's extension: ``.h5``/``.hdf5``, ``.nc``/``.nc4``/
    ``.netcdf``, ``.csv``/``.txt``, ``.npy``/``.npz``."""
    if not isinstance(path, str):
        raise TypeError(f"expected str path, got {type(path)}")
    ext = os.path.splitext(path)[-1].lower().strip()
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        return load_netcdf(path, *args, **kwargs)
    if ext in (".csv", ".txt"):
        return load_csv(path, *args, **kwargs)
    if ext in (".npy", ".npz"):
        return load_npy(path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {ext!r}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by the file's extension (as :func:`load`; ``.npy`` only)."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"expected DNDarray, got {type(data)}")
    ext = os.path.splitext(path)[-1].lower().strip()
    if ext in (".h5", ".hdf5"):
        return save_hdf5(data, path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        return save_netcdf(data, path, *args, **kwargs)
    if ext in (".csv", ".txt"):
        return save_csv(data, path, *args, **kwargs)
    if ext == ".npy":
        return save_npy(data, path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {ext!r}")


def _normalize_slices(slices, shape):
    """One concrete ``slice`` per axis from a user's ``slices`` (a slice or
    a tuple of slices, ``None`` entries allowed), and the shape they
    select."""
    if not isinstance(slices, tuple):
        slices = (slices,)
    if len(slices) > len(shape):
        raise ValueError(f"too many slices for shape {shape}")
    norm, out_shape = [], []
    for d, dim in enumerate(shape):
        s = slices[d] if d < len(slices) else None
        if s is None:
            s = slice(None)
        if not isinstance(s, slice):
            raise TypeError(f"slices entries must be slice/None, got {type(s)}")
        start, stop, step = s.indices(dim)
        norm.append(slice(start, stop, step))
        out_shape.append(max(0, -(-(stop - start) // step)))
    return tuple(norm), tuple(out_shape)


def load_hdf5(path: str, dataset: str, dtype=types.float32, split: Optional[int] = None, device=None, comm=None, slices=None) -> DNDarray:
    """An HDF5 dataset (or the part ``slices`` selects, steps included) as
    a DNDarray of ``dtype``; split, one slab a position."""
    if h5py is None:
        raise RuntimeError("h5py is not available")
    comm = sanitize_comm(comm)
    with h5py.File(path, "r") as handle:
        dset = handle[dataset]
        base, gshape = _normalize_slices(slices if slices is not None else (), dset.shape)
        if split is None or len(gshape) == 0:
            return _place(_read_region(dset, base), dtype, split, device, comm)
        split = split % len(gshape)
        return _assemble_sharded(
            lambda lo, hi: _stream().read_rows(dset, lo, hi, split_axis=split, base=base), gshape, dtype, split, device, comm
        )


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Write ``data`` as an HDF5 dataset, created at the global shape and
    filled one position's shard at a time.  Append modes raise on a name
    that already exists."""
    if h5py is None:
        raise RuntimeError("h5py is not available")
    with h5py.File(path, mode) as handle:
        if dataset in handle:
            raise ValueError(f"dataset {dataset!r} already exists in {path!r}; delete it first or save to a new name")
        dset = handle.create_dataset(dataset, shape=data.shape, dtype=_save_dtype(data), **kwargs)
        if data.split is None:
            _write_region(dset, Ellipsis, data.numpy())
            return
        for slices, slab in _iter_shard_slabs(data):
            _write_region(dset, slices, slab)


def load_netcdf(path: str, variable: str, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A NetCDF variable as a DNDarray, one slab a position along
    ``split`` as :func:`load_hdf5`."""
    comm = sanitize_comm(comm)
    handle = _netcdf_open(path)
    var = None
    try:
        var = handle.variables[variable]
        gshape = tuple(var.shape)
        if split is None or len(gshape) == 0:
            # a copy: the file's memory map closes below
            return _place(np.array(_read_region(var, tuple(slice(0, n) for n in gshape))), dtype, split, device, comm)
        split = split % len(gshape)
        return _assemble_sharded(
            lambda lo, hi: _stream().read_rows(var, lo, hi, split_axis=split, copy=True), gshape, dtype, split, device, comm
        )
    finally:
        var = None  # drop the memory map's views before the file closes
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            handle.close()


def _netcdf_write_var(var, data: DNDarray) -> None:
    if data.split is None:
        _write_region(var, tuple(slice(0, n) for n in data.shape) or Ellipsis, data.numpy())
        return
    for slices, slab in _iter_shard_slabs(data):
        _write_region(var, slices, slab)


def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", **kwargs) -> None:
    """Write ``data`` as a NetCDF variable over dimensions ``dim_0`` ...,
    one position's shard at a time.  scipy's classic-format writer takes
    ``mode="w"`` only."""
    np_dtype = _save_dtype(data)
    dims = tuple(f"dim_{i}" for i in range(data.ndim))
    if netCDF4 is None:
        if _scipy_netcdf is None or mode != "w":
            raise RuntimeError("no NetCDF backend (netCDF4 or scipy) is available")
        with _scipy_netcdf(path, "w") as handle:
            for name, n in zip(dims, data.shape):
                handle.createDimension(name, n)
            _netcdf_write_var(handle.createVariable(variable, np_dtype.char, dims), data)
        return
    with netCDF4.Dataset(path, mode) as handle:
        for name, n in zip(dims, data.shape):
            handle.createDimension(name, n)
        _netcdf_write_var(handle.createVariable(variable, np_dtype, dims), data)


def _csv_row_bounds_py(path: str, header_lines: int, nshards: int):
    """The line-aligned byte range of each position's rows (the chunk rule
    over the data lines; blank and comment lines skipped, as
    ``np.genfromtxt`` skips them), read in one pass of the file."""
    offsets = []
    with open(path, "rb") as fh:
        skipped = 0
        while skipped < header_lines and fh.readline():
            skipped += 1
        pos = fh.tell()
        for line in fh:
            if line.split(b"#", 1)[0].strip():
                offsets.append(pos)
            pos += len(line)
        end = pos
    rows = len(offsets)
    per = -(-rows // nshards) if rows else 0
    bounds = [offsets[k * per] if per and k * per < rows else end for k in range(nshards)]
    if rows:
        bounds[0] = offsets[0]
    bounds.append(end)
    return bounds, rows


def _csv_parse_byte_range(path, start, stop, sep, np_dtype, encoding, native_ok, probe=False) -> np.ndarray:
    """The line-aligned byte range [start, stop) as a 2-D array; ``probe``
    parses only its first line (to count the columns)."""
    if native_ok and not probe:
        from .. import native

        arr = native.csv_parse_range(path, start, stop, sep=sep)
        if arr is not None:
            return arr.astype(np_dtype, copy=False)
    with open(path, "rb") as fh:
        fh.seek(start)
        raw = fh.readline() if probe else fh.read(stop - start)
    arr = np.genfromtxt(_pyio.BytesIO(raw), delimiter=sep, dtype=np_dtype, encoding=encoding or "utf-8")
    return np.atleast_2d(arr) if arr.ndim < 2 else arr


def load_csv(
    path: str,
    header_lines: int = 0,
    sep: str = ",",
    dtype=types.float32,
    encoding: str = "utf-8",
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """A CSV file as a DNDarray.  With ``split=0`` over several positions
    the file is cut into one line-aligned byte range a position and each
    range is parsed and placed on its own; otherwise the file is parsed
    whole.  float32 goes through the native parser, other types through
    numpy's."""
    comm = sanitize_comm(comm)
    np_dtype = _host_dtype(dtype)
    native_ok = len(sep) == 1 and encoding in ("utf-8", "ascii", None) and np_dtype == np.float32
    from .. import native

    if split == 0 and comm.size > 1:
        found = native.csv_row_bounds(path, header_lines, comm.size) if native_ok else None
        bounds, nrows = found if found is not None else _csv_row_bounds_py(path, header_lines, comm.size)
        if nrows > 1:  # one row squeezes to 1-D: the whole-file parse below
            per = -(-nrows // comm.size)
            ncols = _csv_parse_byte_range(path, bounds[0], bounds[-1], sep, np_dtype, encoding, native_ok, probe=True).shape[1]
            gshape = (nrows, ncols) if ncols > 1 else (nrows,)

            def read_slab(lo: int, hi: int) -> np.ndarray:
                if hi <= lo:
                    return np.empty((0, ncols) if ncols > 1 else (0,), dtype=np_dtype)
                r = lo // per
                slab = _csv_parse_byte_range(path, bounds[r], bounds[r + 1], sep, np_dtype, encoding, native_ok)
                return slab if ncols > 1 else slab.reshape(-1)

            return _assemble_sharded(read_slab, gshape, dtype, 0, device, comm)
    arr = native.csv_parse(path, header_lines=header_lines, sep=sep) if native_ok else None
    if arr is not None:
        arr = np.squeeze(arr)  # as genfromtxt: 1-D for one column or row
    else:
        arr = np.genfromtxt(path, delimiter=sep, skip_header=header_lines, dtype=np_dtype, encoding=encoding)
    return _place(arr, dtype, split, device, comm)


def save_csv(
    data: DNDarray,
    path: str,
    header_lines=None,
    sep: str = ",",
    decimals: int = -1,
    encoding: str = "utf-8",
    comm=None,
    truncate: bool = True,
    **kwargs,
) -> None:
    """Write ``data`` as CSV text, one position's rows at a time (a split
    other than 0 is moved to rows first); ``truncate=False`` appends, and
    the header is written only at the start of a file.  ``comm`` is taken
    for the signature's sake."""
    fmt = f"%.{decimals}f" if decimals >= 0 else "%s"
    mode = "w" if truncate else "a"
    appending = mode == "a" and os.path.exists(path) and os.path.getsize(path) > 0
    header = "\n".join(header_lines) if header_lines and not appending else ""
    with open(path, mode, encoding=encoding, newline="") as fh:
        if data.split is None or data.comm.size == 1:
            np.savetxt(fh, data.numpy(), delimiter=sep, fmt=fmt, header=header, comments="")
            return
        if header:
            fh.write(header + "\n")
        if data.split != 0:
            data = data.resplit(0)
        for _, slab in _iter_shard_slabs(data):
            np.savetxt(fh, slab, delimiter=sep, fmt=fmt)


def load_npy(path: str, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A ``.npy`` (memory mapped: one slab a position when split) or the
    first array of a ``.npz`` as a DNDarray; ``dtype`` None keeps the
    file's type."""
    comm = sanitize_comm(comm)
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        gshape = tuple(arr.shape)
        dtype = types.canonical_heat_type(arr.dtype if dtype is None else dtype)
        if split is not None and len(gshape) > 0:
            split = split % len(gshape)
            return _assemble_sharded(
                lambda lo, hi: _stream().read_rows(arr, lo, hi, split_axis=split, copy=True), gshape, dtype, split, device, comm
            )
        arr = np.array(arr)
    else:
        with np.load(path) as npz:
            arr = npz[npz.files[0]]
    return _place(arr, dtype, split, device, comm)


def save_npy(data: DNDarray, path: str) -> None:
    """Write ``data`` as ``.npy``; a split array goes one position's shard
    at a time into a memory-mapped file."""
    if data.split is None:
        np.save(path, data.numpy())
        return
    out = np.lib.format.open_memmap(path, mode="w+", dtype=_save_dtype(data), shape=data.shape)
    try:
        for slices, slab in _iter_shard_slabs(data):
            _write_region(out, slices, slab)
        out.flush()
    finally:
        del out


DNDarray.save = lambda self, path, *args, **kwargs: save(self, path, *args, **kwargs)
DNDarray.save_hdf5 = lambda self, path, dataset, mode="w", **kw: save_hdf5(self, path, dataset, mode, **kw)
DNDarray.save_netcdf = lambda self, path, variable, mode="w", **kw: save_netcdf(self, path, variable, mode, **kw)
