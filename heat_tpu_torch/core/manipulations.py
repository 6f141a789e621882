"""Shape manipulations (counterpart of heat_tpu/core/manipulations.py):
``reshape`` and ``concatenate``, over the shard list.

Where the result's shards are the operands' shards reshaped or joined
position by position, each position works alone; otherwise the operands
are gathered, the result is formed once and cut anew for its split.  The
JAX package's tiled transport engine (a later slice, ROADMAP item 7) moves
the same values without the gather.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from . import sanitation, stride_tricks, types
from .dndarray import DNDarray, _wrap

__all__ = ["concatenate", "reshape"]


def _torch_dtype(a) -> torch.dtype:
    return a.dtype.torch_type() if isinstance(a, DNDarray) else torch.as_tensor(a).dtype


def reshape(a: DNDarray, *shape, new_split=None) -> DNDarray:
    """Reshape (heat_tpu/core/manipulations.py:288).  ``new_split`` sets the
    result's split; by default it keeps the input's split where the new
    shape has that dimension, else 0 for a split input."""
    sanitation.sanitize_in(a)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = stride_tricks.sanitize_shape(shape, lval=-1)
    known = [d for d in shape if d != -1]
    n_unknown = len(shape) - len(known)
    prod = math.prod(known)
    if n_unknown > 1:
        raise ValueError("can only specify one unknown dimension")
    if (n_unknown == 0 and prod != a.size) or (n_unknown == 1 and (prod == 0 or a.size % prod)):
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    gout = tuple(a.size // prod if d == -1 else int(d) for d in shape)
    if new_split is None:
        new_split = None if a.split is None else (a.split if a.split < len(gout) else 0)
    new_split = stride_tricks.sanitize_axis(gout, new_split) if gout else None
    if (
        a.split is not None
        and new_split is not None
        and a.comm.size > 1
        and math.prod(a.shape[: a.split]) == math.prod(gout[:new_split])
        and a.shape[a.split] == gout[new_split]
    ):
        # the split dimension keeps its extent and everything before it:
        # every position reshapes its own block
        shards = []
        for s in a.shards:
            local = list(gout)
            local[new_split] = s.shape[a.split]
            shards.append(s.reshape(local))
        return DNDarray(shards, gout, a.dtype, new_split, a.device, a.comm)
    return _wrap(a.larray.reshape(gout), new_split, a.device, a.comm)


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis (heat_tpu/core/manipulations.py:123).
    The first split operand's split is the result's."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("need at least one array to concatenate")
    ref = next((a for a in arrays if isinstance(a, DNDarray)), None)
    if ref is None:
        raise TypeError("concatenate needs at least one DNDarray")
    axis = stride_tricks.sanitize_axis(ref.shape, axis)
    for a in arrays[1:]:
        shp = tuple(a.shape)
        if len(shp) != ref.ndim or any(shp[d] != ref.shape[d] for d in range(ref.ndim) if d != axis):
            raise ValueError(
                "all input array dimensions except the concatenation axis must match: "
                f"{ref.shape} vs {shp} on axis {axis}"
            )
    split = next((a.split for a in arrays if isinstance(a, DNDarray) and a.split is not None), None)
    # promotion as jnp.concatenate's: an integer meets a float at the float
    dtype = functools.reduce(torch.promote_types, [_torch_dtype(a) for a in arrays])
    gshape = list(ref.shape)
    gshape[axis] = sum(a.shape[axis] for a in arrays)
    if (
        split is not None
        and split != axis
        and all(isinstance(a, DNDarray) and a.split == split for a in arrays)
    ):
        # split off the joined axis: the shards line up position by position
        shards = [
            torch.cat([a.shards[r].to(dtype) for a in arrays], dim=axis) for r in range(ref.comm.size)
        ]
        return DNDarray(shards, tuple(gshape), types.canonical_heat_type(dtype), split, ref.device, ref.comm)
    tdev = ref.shards[0].device
    parts = [
        (a.larray if isinstance(a, DNDarray) else torch.as_tensor(a, device=tdev)).to(dtype)
        for a in arrays
    ]
    return _wrap(torch.cat(parts, dim=axis), split, ref.device, ref.comm)
