"""Sparse op machinery (counterpart of heat_tpu/sparse/_operations.py).

Elementwise CSR-CSR operations are position-local: a row's result depends
only on that row in the two operands, so a row-split op needs no
collective.  Per position, on its device:

1. expand both operands' row pointers to per-entry rows and form the key
   ``row·ncols + col`` (int64);
2. concatenate the operands (the first operand first) and sort the keys
   stably, so a (row, col) present in both comes out as an adjacent pair,
   the first operand's entry first;
3. add sums each pair and keeps single entries; mul multiplies each pair
   and drops single entries; stored zeros are dropped (scipy's
   ``eliminate_zeros``);
4. the survivors, in (row, col) order, give the new triple, their row
   pointers read off the sorted rows by ``searchsorted``.
"""

from __future__ import annotations

import torch

from ..core import types

__all__ = []


def _expand_rows(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row (within the triple) of each of its ``nnz`` entries, int64."""
    rows = indptr.numel() - 1
    counts = (indptr[1:] - indptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(torch.arange(rows, device=indptr.device), counts, output_size=nnz)


def _merge_local(mode: str, a, b, ncols: int, tt: torch.dtype):
    """Merge two CSR triples of one row block elementwise."""
    (da, ia, pa), (db, ib, pb) = a, b
    rows = pa.numel() - 1
    dev = da.device
    keys = torch.cat((
        _expand_rows(pa, da.numel()) * ncols + ia.to(torch.int64),
        _expand_rows(pb, db.numel()) * ncols + ib.to(torch.int64).to(dev),
    ))
    vals = torch.cat((da.to(tt), db.to(device=dev, dtype=tt)))
    keys, order = torch.sort(keys, stable=True)
    vals = vals[order]
    same_next = torch.zeros_like(keys, dtype=torch.bool)
    same_next[:-1] = keys[1:] == keys[:-1]
    nxt = torch.zeros_like(vals)
    nxt[:-1] = vals[1:]
    if mode == "add":
        same_prev = torch.zeros_like(same_next)
        same_prev[1:] = same_next[:-1]
        out = vals + torch.where(same_next, nxt, torch.zeros_like(nxt))
        keep = ~same_prev
    elif mode == "mul":
        out = vals * nxt
        keep = same_next  # intersection: the first entry of each pair
    else:
        raise ValueError(f"unknown sparse op {mode!r}")
    keep &= out != 0
    keys, out = keys[keep], out[keep]
    row = keys // ncols
    indptr = torch.searchsorted(row, torch.arange(rows + 1, device=dev), right=False).to(torch.int32)
    return out, (keys - row * ncols).to(torch.int32), indptr


def _binary_op_csr(mode: str, t1, t2):
    """Elementwise CSR-CSR operation, position by position; see the module
    docstring."""
    from .dcsr_matrix import DCSR_matrix

    if not isinstance(t1, DCSR_matrix) or not isinstance(t2, DCSR_matrix):
        raise TypeError(f"inputs must be DCSR_matrix, got {type(t1)}, {type(t2)}")
    if t1.shape != t2.shape:
        raise ValueError(f"shapes do not match: {t1.shape} vs {t2.shape}")
    out_split = t1.split if t1.split is not None else t2.split
    if t1.split != t2.split:
        t2 = t2.resplit(t1.split) if t1.split is not None else t2
        t1 = t1.resplit(out_split)
    out_dtype = types.promote_types(t1.dtype, t2.dtype)
    tt = out_dtype.torch_type()
    ncols = t1.shape[1]
    shards = [_merge_local(mode, a, b, ncols, tt) for a, b in zip(t1._shards, t2._shards)]
    return DCSR_matrix._from_shards(shards, t1.shape, out_dtype, out_split, t1.device, t1.comm)
