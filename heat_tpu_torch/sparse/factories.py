"""Sparse factories (counterpart of heat_tpu/sparse/factories.py):
``sparse_csr_matrix``.

The input is brought to canonical CSR on the host (duplicates summed,
columns sorted within each row), cut into row chunks by the chunk rule, and
each chunk's triple is placed on the target device; the matrix is never
densified.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import devices as ht_devices
from ..core import types
from ..core.dndarray import DNDarray
from ..parallel.mesh import sanitize_comm
from .dcsr_matrix import DCSR_matrix

__all__ = ["sparse_csr_matrix"]


def sparse_csr_matrix(
    obj,
    dtype=None,
    copy: bool = True,
    is_split: Optional[int] = None,
    device=None,
    comm=None,
    split: Optional[int] = None,
    min_row_cap: int = 0,
    pow2_cap: bool = False,
) -> DCSR_matrix:
    """A :class:`DCSR_matrix` from a scipy sparse matrix, a DCSR matrix, a
    DNDarray or a dense array-like; ``split=0`` cuts the rows over the
    mesh.

    ``min_row_cap`` and ``pow2_cap`` are accepted for the JAX package's
    signature: there they size the padded slab capacity that one compiled
    program shares across requests.  The port keeps no padded capacity, so
    they change nothing, and never a value."""
    comm = sanitize_comm(comm)
    import scipy.sparse

    if isinstance(obj, DCSR_matrix):
        device = obj.device if device is None else device
        sp = obj.to_scipy()
    elif scipy.sparse.issparse(obj):
        sp = obj.tocsr()
        if sp is obj:
            # canonicalising below must not touch the caller's arrays
            sp = sp.copy()
    elif isinstance(obj, DNDarray):
        device = obj.device if device is None else device
        sp = scipy.sparse.csr_matrix(obj.numpy())
    elif isinstance(obj, torch.Tensor):
        sp = scipy.sparse.csr_matrix(obj.detach().cpu().numpy())
    else:
        sp = scipy.sparse.csr_matrix(np.asarray(obj))
    device = ht_devices.sanitize_device(device)
    sp.sum_duplicates()
    sp.sort_indices()
    heat_type = types.canonical_heat_type(sp.data.dtype if dtype is None else dtype)

    if split not in (None, 0) or is_split not in (None, 0):
        raise ValueError("sparse matrices support split=0 (row chunks) only")
    final_split = 0 if (split == 0 or is_split == 0) else None
    nrows, ncols = sp.shape
    nsh = comm.size if final_split == 0 else 1
    tdev = device.torch_device
    tt = heat_type.torch_type()

    shards = []
    for r in range(nsh):
        off, lshape, _ = comm.chunk((nrows, ncols), 0, rank=r) if nsh > 1 else (0, (nrows, ncols), None)
        lo, hi = off, off + lshape[0]
        a, b = int(sp.indptr[lo]), int(sp.indptr[hi])
        ptr = (sp.indptr[lo : hi + 1].astype(np.int64) - a).astype(np.int32)
        shards.append((
            torch.from_numpy(np.ascontiguousarray(sp.data[a:b])).to(device=tdev, dtype=tt),
            torch.from_numpy(np.ascontiguousarray(sp.indices[a:b], dtype=np.int32)).to(tdev),
            torch.from_numpy(ptr).to(tdev),
        ))
    return DCSR_matrix(shards, int(sp.nnz), (nrows, ncols), heat_type, final_split, device, comm)
