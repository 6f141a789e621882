"""Build and load the port's CUDA kernels.

Each library is compiled by ``nvcc`` from the sources under
``heat_tpu_torch/csrc/`` at first use, into ``heat_tpu_torch/_build/``, under
a name keyed on a hash of the sources, the headers they include and the
flags: a change to any of them builds anew, and an unchanged checkout
reuses what it built.  The library has a plain C interface and is loaded
with ``ctypes``.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: per library: build seconds (0.0 when reused) and the compiler's report
#: (``-Xptxas -v`` gives each kernel's registers and shared memory)
BUILD_INFO: Dict[str, dict] = {}

_LOADED: Dict[str, ctypes.CDLL] = {}
# one lock per library: different libraries build side by side
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _with_headers(sources: Sequence[Path]) -> list:
    """``sources`` and every header under ``CSRC`` that they include with
    ``#include "..."``, directly or through another header."""
    seen, todo = [], list(sources)
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / name.decode()
            if header.is_file():
                todo.append(header)
    return seen


def _digest(sources: Sequence[Path]) -> str:
    """A hash of the flags, the sources and the headers they include, so
    that an edit to a shared header builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _with_headers(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The library ``name`` built from ``csrc/<sources>``; builds it first
    when no library of these sources exists yet.  Threads may build
    different libraries at once."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        paths = [CSRC / s for s in sources]
        target = BUILD_DIR / f"lib{name}-{_digest(paths)}.so"
        if target.is_file():
            BUILD_INFO[name] = {"seconds": 0.0, "log": "", "path": str(target)}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)  # atomic: a reader never sees half a library
            BUILD_INFO[name] = {
                "seconds": time.perf_counter() - t0,
                "log": proc.stdout + proc.stderr,
                "path": str(target),
            }
        lib = ctypes.CDLL(str(target))
        _LOADED[name] = lib
        return lib

