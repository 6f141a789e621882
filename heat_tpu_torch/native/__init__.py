"""The host's native library (counterpart of heat_tpu/native/): byte-range
CSV parsing and row bounds, threaded byte reads, a prefetch pipeline over a
file's bytes, and a Threefry-2x64 counter stream.

The C++ sources under ``native/src/`` are built by ``g++`` at first use into
``heat_tpu_torch/_build/``, under a name keyed on a hash of the sources and
the flags, and loaded with ``ctypes``.  A failure to build or load raises
with the compiler's output: no caller takes another route because the
library is missing.  The Threefry stream does not drive ``random`` yet; it
is the host check for a device Threefry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "lib",
    "csv_parse",
    "csv_parse_range",
    "csv_row_bounds",
    "read_bytes",
    "threefry_fill",
    "threefry_permutation",
    "PrefetchPipeline",
]

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("io_engine.cpp", "prefetch.cpp", "threefry.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_THREADS = min(os.cpu_count() or 1, 16)


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(str(SRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        os.unlink(tmp)
        raise RuntimeError(f"building the native library failed ({' '.join(cmd)}): {err}") from err
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native library failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a library


def _declare(lib: ctypes.CDLL) -> None:
    c_long, c_int, c_char, c_void_p = ctypes.c_long, ctypes.c_int, ctypes.c_char, ctypes.c_void_p
    f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    longp = ctypes.POINTER(c_long)
    sigs = {
        "ht_file_size": (c_long, [ctypes.c_char_p]),
        "ht_csv_parse": (c_long, [ctypes.c_char_p, c_long, c_char, c_int, f32pp, longp]),
        "ht_csv_parse_range": (c_long, [ctypes.c_char_p, c_long, c_long, c_char, c_int, f32pp, longp]),
        "ht_csv_row_bounds": (c_long, [ctypes.c_char_p, c_long, c_long, longp, longp]),
        "ht_read_bytes": (c_long, [ctypes.c_char_p, c_long, c_long, c_void_p, c_int]),
        "ht_free": (None, [c_void_p]),
        "ht_prefetch_open": (c_void_p, [ctypes.c_char_p, c_long, c_long, c_long, c_int]),
        "ht_prefetch_next": (c_long, [c_void_p, c_void_p, c_long]),
        "ht_prefetch_close": (None, [c_void_p]),
        "ht_threefry_fill_u64": (None, [ctypes.c_uint64, ctypes.c_uint64, c_long, c_void_p, c_int]),
        "ht_threefry_permutation": (None, [ctypes.c_uint64, c_long, c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def lib() -> ctypes.CDLL:
    """The native library, built first when this checkout has none of
    these sources yet; raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libheat_native-{_digest()}.so"
            if not target.is_file():
                _build(target)
            loaded = ctypes.CDLL(str(target))
            _declare(loaded)
            _lib = loaded
        return _lib


def available() -> bool:
    """True once the library builds and loads (raises otherwise)."""
    return lib() is not None


def _take_floats(out, n: int, rows: int) -> np.ndarray:
    """The library's (rows, n // rows) float buffer as a numpy copy; the
    buffer is freed."""
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib().ht_free(out)
    return arr.reshape(rows, n // rows)


def csv_parse(path: str, header_lines: int = 0, sep: str = ",") -> Optional[np.ndarray]:
    """The CSV as a float32 (rows, cols) array, parsed by a thread per byte
    range; ``None`` for a ragged or unreadable file or one without rows
    (the numpy parser then gives the user's error)."""
    out = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_long()
    n = lib().ht_csv_parse(path.encode(), header_lines, sep.encode()[:1], _THREADS, ctypes.byref(out), ctypes.byref(rows))
    if n < 0:
        return None
    if rows.value == 0:
        lib().ht_free(out)
        return None
    return _take_floats(out, n, rows.value)


def csv_row_bounds(path: str, header_lines: int, nshards: int):
    """``(bounds, nrows)``: ``bounds[k]:bounds[k+1]`` is position k's
    line-aligned byte range under the chunk rule over the file's data rows;
    ``None`` when the scan fails."""
    bounds = (ctypes.c_long * (nshards + 1))()
    nrows = ctypes.c_long()
    if lib().ht_csv_row_bounds(path.encode(), header_lines, nshards, bounds, ctypes.byref(nrows)) != 0:
        return None
    return list(bounds), nrows.value


def csv_parse_range(path: str, start: int, end: int, sep: str = ",") -> Optional[np.ndarray]:
    """The line-aligned byte range [start, end) as a float32 (rows, cols)
    array; (0, 0) for an empty range, ``None`` for ragged rows or an I/O
    error."""
    l = lib()
    if end <= start:
        return np.empty((0, 0), dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_long()
    n = l.ht_csv_parse_range(path.encode(), start, end, sep.encode()[:1], _THREADS, ctypes.byref(out), ctypes.byref(rows))
    if n < 0:
        return None
    if rows.value == 0:
        l.ht_free(out)
        return np.empty((0, 0), dtype=np.float32)
    return _take_floats(out, n, rows.value)


def read_bytes(path: str, offset: int, size: int) -> Optional[np.ndarray]:
    """``size`` bytes at ``offset`` as a uint8 array, read by threads;
    ``None`` on a short read."""
    buf = np.empty(size, dtype=np.uint8)
    got = lib().ht_read_bytes(path.encode(), offset, size, buf.ctypes.data_as(ctypes.c_void_p), _THREADS)
    return buf if got == size else None


def threefry_fill(seed: int, counter: int, n: int, nthreads: Optional[int] = None) -> np.ndarray:
    """``n`` uint64 of the (seed, counter) Threefry-2x64 stream, the same
    for every thread count."""
    out = np.empty(n, dtype=np.uint64)
    lib().ht_threefry_fill_u64(
        seed & (2**64 - 1), counter & (2**64 - 1), n, out.ctypes.data_as(ctypes.c_void_p),
        _THREADS if nthreads is None else nthreads,
    )
    return out


def threefry_permutation(seed: int, n: int) -> np.ndarray:
    """A permutation of [0, n) drawn from the seeded stream."""
    out = np.empty(n, dtype=np.int64)
    lib().ht_threefry_permutation(seed & (2**64 - 1), n, out.ctypes.data_as(ctypes.c_void_p))
    return out


class PrefetchPipeline:
    """Byte slabs of a file, read ahead by a C++ thread; an iterator and a
    context manager (``close`` stops the reader)."""

    def __init__(self, path: str, offset: int = 0, nbytes: int = -1, slab_bytes: int = 8 << 20, depth: int = 2):
        self._handle = None
        self._lib = lib()
        self._slab_bytes = slab_bytes
        self._handle = self._lib.ht_prefetch_open(path.encode(), offset, nbytes, slab_bytes, depth)
        if not self._handle:
            raise OSError(f"cannot open {path!r}")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        buf = np.empty(self._slab_bytes, dtype=np.uint8)
        got = self._lib.ht_prefetch_next(self._handle, buf.ctypes.data_as(ctypes.c_void_p), self._slab_bytes)
        if got == 0:
            self.close()
            raise StopIteration
        if got < 0:
            self.close()
            raise OSError("prefetch reader failed")
        return buf[:got]

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ht_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
