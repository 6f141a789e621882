"""Sparse matrix times dense vectors, K6 of the port (counterpart of
heat_tpu/ops/spmv.py, whose Pallas kernel ``_spmv_kernel`` this replaces).

The kernel's operand is a CSR row block repacked once with torch ops on
the triple's device (:func:`csr_panels`): the entries ordered by column
panel of :data:`PANEL_COLS` columns, then by row, then as the CSR holds
them, with the bounds of each (panel, row) run.  No pad slot exists.  The
kernel walks x panel by panel with each panel staged in shared memory; a
tile's runs in one panel lie next to each other, so it streams them.
Where a row holds less than a quad of entries a panel on average (a k-NN
graph's ~1), the repacking is one panel over every column instead, the
CSR's own order, and the kernel gathers x from memory: a panel step per
entry would cost a round trip to memory and a barrier each.

:func:`spmv` launches the hand-written CUDA kernel in ``csrc/spmv.cu`` for
tensors on the card; for tensors on the CPU it computes
:func:`reference_spmv`, the same function in plain torch ops.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.

The JAX package's operand, ELL slabs ``(vals (rows, W) f32, cols (rows, W)
int32)`` with row r's entries in its first slots and pads of value 0 and
column −1, stays here as :func:`ell_pack` and its plain product
:func:`reference_spmv_ell`: the parity tests hold both packings to the JAX
package.  W is the densest row rounded up to a multiple of 32 (one warp;
the JAX package rounds to the TPU's 128 lanes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = ["Panels", "csr_panels", "ell_pack", "ell_width", "plan", "reference_spmv", "reference_spmv_ell", "spmv"]

#: kernel launches so far; :func:`spmv` adds one per launch and nowhere else
launches = 0

#: slab widths are multiples of one warp
WARP = 32

# the kernel's geometry, as ``csrc/spmv.cu`` defines it (kSubCols,
# kTileRows, kUnroll): the repacking's column panel (x rows one of the
# kernel's two shared-memory buffers holds), the rows of a tile (one a lane
# of its 1024 threads), and the quads of entries a lane loads from a run
# before its gathers
PANEL_COLS = 6144
TILE_ROWS = 1024
UNROLL = 2
#: a tile's least rows where the rows would spread thinner over the SMs
MIN_TILE_ROWS = 256
#: entries a row holds a panel, on average, from which x is staged by panel
STAGE_RUN = 4

_SOURCES = ("spmv.cu",)
# heat_spmv_panels_f32(pvals, pcols, off, x, y, rows, ncols, k, tpr, tiles, grid, staged, sub_cols, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_fn = None
_SMS = {}


class Panels(NamedTuple):
    """A CSR row block repacked for the kernel (:func:`csr_panels`):
    ``vals`` f32 and ``cols`` int32 of its ``nnz`` entries ordered by column
    panel, row and CSR order (fillers to a multiple of 4 at the end), and
    ``off`` int32 of panels·rows + 1 run bounds: row r's entries in panel s
    are ``[off[s·rows + r], off[s·rows + r + 1])``.  ``staged``: panels of
    PANEL_COLS columns, x staged in shared memory; else one panel over
    every column, x gathered from memory."""

    vals: torch.Tensor
    cols: torch.Tensor
    off: torch.Tensor
    rows: int
    ncols: int
    nnz: int
    staged: bool


class Plan(NamedTuple):
    """One launch's geometry: ``kc`` right-hand sides a pass over
    ``passes`` passes, ``panels`` runs a row (x panels of PANEL_COLS rows
    when staged), ``tpr`` threads a row, ``tiles`` tiles of at most
    ``tile_rows`` rows over ``grid`` CTAs."""

    kc: int
    passes: int
    panels: int
    tpr: int
    tiles: int
    tile_rows: int
    grid: int


def _panel_count(ncols: int, staged: bool) -> int:
    return max(1, -(-ncols // PANEL_COLS)) if staged else 1


@functools.lru_cache(maxsize=64)
def plan(rows: int, ncols: int, nnz: int, k: int, sms: int, staged: bool) -> Plan:
    """The launch geometry for ``rows`` rows of ``nnz`` entries over x of
    ``ncols`` rows and ``k`` columns on a card of ``sms`` SMs, repacked by
    panel (``staged``) or not.  A row's threads are the fewest of 2, 4, 8,
    16 whose ``UNROLL`` quads each cover a mean run; the tiles are at
    least one an SM where the rows allow ``MIN_TILE_ROWS`` each, a multiple
    of the SMs beyond that."""
    panels = _panel_count(ncols, staged)
    run = nnz / max(1, rows * panels)
    tpr = next((t for t in (2, 4, 8) if 4 * t * UNROLL >= run), 16)
    tiles = max(-(-rows // TILE_ROWS), min(sms, -(-rows // MIN_TILE_ROWS)), 1)
    if tiles > sms:
        tiles = -(-tiles // sms) * sms
    tile_rows = -(-rows // tiles)
    tiles = -(-rows // tile_rows) if rows else 1
    return Plan(1 if k == 1 else 4, 1 if k == 1 else -(-k // 4), panels, tpr, tiles, tile_rows, min(sms, tiles))


def ell_width(max_row_nnz: int) -> int:
    """ELL slab width for a row block whose densest row holds
    ``max_row_nnz`` entries: rounded up to a multiple of 32, at least 32."""
    need = max(1, int(max_row_nnz))
    return -(-need // WARP) * WARP


def ell_pack(data: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor, width: int):
    """Repack one CSR triple (``indptr`` over its rows, rebased to 0) into
    ELL slabs ``(vals (rows, width) f32, cols (rows, width) int32)`` on the
    triple's device.  Pad slots carry value 0 and column −1."""
    indptr = indptr.to(torch.int64)
    rows = indptr.numel() - 1
    nnz = data.numel()
    dev = data.device
    counts = indptr[1:] - indptr[:-1]
    vals = torch.zeros((rows, width), dtype=torch.float32, device=dev)
    cols = torch.full((rows, width), -1, dtype=torch.int32, device=dev)
    if nnz:
        if int(counts.max()) > width:
            raise ValueError(f"a row with {int(counts.max())} entries exceeds the slab width {width}")
        row_of = torch.repeat_interleave(torch.arange(rows, device=dev), counts, output_size=nnz)
        flat = row_of * width + torch.arange(nnz, device=dev) - indptr[:-1][row_of]
        vals.view(-1)[flat] = data.to(torch.float32)
        cols.view(-1)[flat] = indices.to(torch.int32)
    return vals, cols


def csr_panels(data: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor, ncols: int) -> Panels:
    """The kernel's operand for one CSR triple (``indptr`` over its rows,
    rebased to 0) over ``ncols`` columns, on the triple's device: the
    entries ordered by column panel, then row, then CSR order, and the
    bounds of each (panel, row) run.  The panels are of ``PANEL_COLS``
    columns (x staged) where a row holds ``STAGE_RUN`` entries a panel on
    average, else one panel over every column (x gathered).  Built once
    per matrix; it holds the values, so it is built again after they
    change."""
    indptr = indptr.to(torch.int64)
    rows, nnz, dev, ncols = indptr.numel() - 1, data.numel(), data.device, int(ncols)
    if nnz >= 2**31 - 4:
        raise ValueError(f"{nnz} entries exceed the kernel's int32 run bounds")
    staged = nnz >= STAGE_RUN * rows * _panel_count(ncols, True)
    nsub = _panel_count(ncols, staged)
    row_of = torch.repeat_interleave(torch.arange(rows, device=dev), indptr[1:] - indptr[:-1], output_size=nnz)
    key = row_of if nsub == 1 else (indices.to(torch.int64) // PANEL_COLS) * rows + row_of
    key, order = torch.sort(key, stable=True)
    size = -(-max(nnz, 1) // 4) * 4
    pvals = torch.zeros(size, dtype=torch.float32, device=dev)
    pcols = torch.zeros(size, dtype=torch.int32, device=dev)
    pvals[:nnz] = data[order].to(torch.float32)
    pcols[:nnz] = indices[order].to(torch.int32)
    off = torch.zeros(nsub * rows + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(torch.bincount(key, minlength=nsub * rows), 0)
    return Panels(pvals, pcols, off.to(torch.int32), rows, ncols, nnz, staged)


def reference_spmv(panels: Panels, x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``y[r] = Σ vals·x[cols]`` over row r's entries in
    every panel, in f32; x is (ncols,) or (ncols, k) and y (rows,) or
    (rows, k)."""
    vec = x.ndim == 1
    x2 = (x[:, None] if vec else x).to(torch.float32)
    counts = (panels.off[1:] - panels.off[:-1]).to(torch.int64)
    nruns = counts.numel()
    row_of = torch.repeat_interleave(torch.arange(nruns, device=counts.device) % max(1, panels.rows), counts,
                                     output_size=panels.nnz)
    prod = panels.vals[: panels.nnz, None] * x2.index_select(0, panels.cols[: panels.nnz].to(torch.int64))
    y = torch.zeros((panels.rows, x2.shape[1]), dtype=torch.float32, device=x2.device).index_add_(0, row_of, prod)
    return y[:, 0] if vec else y


def reference_spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The product over ELL slabs, as the JAX package's kernel computes it:
    ``y[r] = Σⱼ vals[r, j]·x[cols[r, j]]`` with pad slots (``cols < 0``)
    adding 0, in f32; x is (ncols,) or (ncols, k) and y (rows,) or
    (rows, k)."""
    vec = x.ndim == 1
    x2 = (x[:, None] if vec else x).to(torch.float32)
    live = cols >= 0
    safe = torch.where(live, cols, torch.zeros((), dtype=cols.dtype, device=cols.device))
    g = x2.index_select(0, safe.reshape(-1)).reshape(*cols.shape, x2.shape[1])
    prod = torch.where(live[..., None], vals.to(torch.float32)[..., None] * g, torch.zeros((), device=g.device))
    y = prod.sum(dim=1)
    return y[:, 0] if vec else y


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_spmv", _SOURCES).heat_spmv_panels_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def spmv(panels: Panels, x: torch.Tensor) -> torch.Tensor:
    """``y = A·x`` for A repacked by :func:`csr_panels` and x of shape
    (ncols,) or (ncols, k); y is (rows,) or (rows, k) f32.

    On the card: the repacking and x f32 on one device.  A zero-row block
    or k = 0 returns without a launch.  The kernel trusts every column id
    to be below ncols (:func:`csr_panels` of a valid CSR triple guarantees
    it).  For k = 1 and k = 4 the kernel reads x as it is (a copy where it
    is not 16-byte aligned); other k are copied into passes of 4 columns."""
    global launches
    if not isinstance(panels, Panels):
        raise TypeError(f"spmv takes the repacking csr_panels makes, got {type(panels)}")
    if x.ndim not in (1, 2) or x.shape[0] != panels.ncols:
        raise ValueError(f"x must be ({panels.ncols},) or ({panels.ncols}, k), got {tuple(x.shape)}")
    dev = panels.vals.device
    if dev.type == "cpu" and x.device.type == "cpu":
        return reference_spmv(panels, x)
    if dev.type != "cuda" or x.device != dev or panels.off.device != dev:
        raise ValueError(f"spmv needs its operands on one CUDA device, got {dev} and {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the spmv kernel takes float32 x, got {x.dtype}")
    rows, ncols = panels.rows, panels.ncols
    vec = x.ndim == 1
    x2 = x[:, None] if vec else x
    k = x2.shape[1]
    if max(rows, ncols) >= 2**31 or k > 4 * 65535:
        raise ValueError(f"{rows} rows over x ({ncols}, {k}) exceed the kernel's grid")
    y = torch.empty((rows, k), dtype=torch.float32, device=dev)
    if rows and k:
        geo = plan(rows, ncols, panels.nnz, k, _sms(dev), panels.staged)
        if k == 1 or (k == 4 and x2.is_contiguous()):
            xs = x2.contiguous()
            xs = xs if xs.data_ptr() % 16 == 0 else xs.clone()
        else:
            pad = torch.nn.functional.pad(x2, (0, 4 * geo.passes - k))
            xs = pad.reshape(ncols, geo.passes, 4).transpose(0, 1).contiguous()
        pv, pc, off = panels.vals, panels.cols, panels.off
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _kernel()(pv.data_ptr(), pc.data_ptr(), off.data_ptr(), xs.data_ptr(), y.data_ptr(), rows,
                            ncols, k, geo.tpr, geo.tiles, geo.grid, int(panels.staged), PANEL_COLS, stream)
        if err != 0:
            raise RuntimeError(f"spmv kernel launch failed with cudaError_t {err}")
        launches += 1
    return y[:, 0] if vec else y
