"""Printing (counterpart of heat_tpu/core/printing.py): ``__str__`` of a
DNDarray and the print options.

The string is numpy's ``array2string`` of the global array under the
options below, as in heat_tpu.  A summarised array (more elements than
``threshold``) shows only the ``edgeitems`` leading and trailing entries of
each dimension, and numpy picks its column widths from those same entries.
So only they are fetched: per dimension longer than ``2 * edgeitems`` the
leading and trailing blocks plus one entry between them, which numpy's
summary drops again; the rest of the array never leaves its shards.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_printoptions", "global_printing", "local_printing", "print0", "set_printoptions"]

_printoptions = {"threshold": 1000, "edgeitems": 3, "precision": 4, "linewidth": 120}
_LOCAL_PRINTING = False

#: bytes the last summarised ``__str__`` moved to the host
last_bytes_moved = 0


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Set the print options; ``profile`` is ``"default"``, ``"short"`` or
    ``"full"``."""
    if profile == "default":
        _printoptions.update(threshold=1000, edgeitems=3, precision=4)
    elif profile == "short":
        _printoptions.update(threshold=1000, edgeitems=2, precision=2)
    elif profile == "full":
        _printoptions.update(threshold=np.inf, edgeitems=3, precision=4)
    for key, val in (("precision", precision), ("threshold", threshold), ("edgeitems", edgeitems), ("linewidth", linewidth)):
        if val is not None:
            _printoptions[key] = val


def get_printoptions() -> dict:
    """The current print options."""
    return dict(_printoptions)


def local_printing() -> None:
    """Print the first position's shard only."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = True


def global_printing() -> None:
    """Print the global array (the default)."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = False


def print0(*args, **kwargs) -> None:
    """``print`` once: one process drives every position."""
    print(*args, **kwargs)


def _edge_index(n: int, edge: int) -> torch.Tensor:
    """The entries of an extent ``n`` a summary reads: all of them up to
    ``2 * edge``, else the leading and trailing ``edge`` and one between."""
    if n <= 2 * edge:
        return torch.arange(n)
    return torch.cat([torch.arange(edge + 1), torch.arange(n - edge, n)])


def _edges(x) -> np.ndarray:
    """The summary's entries of ``x`` as a host array: each shard cut down
    to them on its device before anything moves."""
    from .dndarray import _host

    edge = int(_printoptions["edgeitems"])
    idx = [_edge_index(n, edge) for n in x.shape]
    split = x.split if x.is_distributed() else None
    parts = []
    shards = x.shards if split is not None else x.shards[:1]
    for r, s in enumerate(shards):
        sel = idx
        if split is not None:
            lo = x.comm.chunk(x.shape, split, rank=r)[0]
            mine = idx[split][(idx[split] >= lo) & (idx[split] < lo + s.shape[split])]
            if mine.numel() == 0:
                continue
            sel = idx[:split] + [mine - lo] + idx[split + 1 :]
        for d, i in enumerate(sel):
            s = s.index_select(d, i.to(s.device))
        parts.append(s)
    small = parts[0] if len(parts) == 1 else torch.cat(parts, dim=split)
    global last_bytes_moved
    last_bytes_moved = small.numel() * small.element_size()
    return _host(small)


def __str__(dndarray) -> str:
    """``DNDarray(<numpy's array2string>, dtype=ht.<type>, device=<device>,
    split=<split>)``, the string heat_tpu prints for the same values."""
    opts = _printoptions
    threshold = opts["threshold"] if np.isfinite(opts["threshold"]) else 2**63 - 1
    edge = int(opts["edgeitems"])
    kwargs = dict(precision=opts["precision"], threshold=threshold, edgeitems=edge, linewidth=opts["linewidth"])
    if _LOCAL_PRINTING:
        with np.printoptions(**kwargs):
            body = np.array2string(dndarray.lshards()[0])
    elif dndarray.size > threshold and edge > 0:
        small = _edges(dndarray)
        # the cut array keeps a summary: one entry between the edges of every
        # cut dimension, and a threshold below its own size
        kwargs["threshold"] = min(threshold, small.size - 1)
        with np.printoptions(**kwargs):
            body = np.array2string(small)
    else:
        with np.printoptions(**kwargs):
            body = np.array2string(dndarray.numpy())
    return f"DNDarray({body}, dtype=ht.{dndarray.dtype.__name__}, device={dndarray.device}, split={dndarray.split})"
