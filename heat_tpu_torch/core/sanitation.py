"""Input validation (counterpart of heat_tpu/core/sanitation.py)."""

from __future__ import annotations

from typing import Union

import torch

from .dndarray import DNDarray

__all__ = [
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_out",
    "sanitize_distribution",
    "sanitize_lshape",
    "sanitize_sequence",
    "scalar_to_1d",
]


def sanitize_in(x) -> None:
    """Raise unless ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, got {type(x)}")


def sanitize_in_tensor(x) -> torch.Tensor:
    """A DNDarray's global tensor (a gather for a split array), or an
    array-like as a tensor."""
    if isinstance(x, DNDarray):
        return x.larray
    return torch.as_tensor(x)


def sanitize_out(out, result: DNDarray) -> DNDarray:
    """Write ``result`` into the ``out=`` target (heat_tpu/core/sanitation.py:44):
    ``out`` must be a DNDarray of the result's shape; it takes the result's
    values, cast to its own dtype, and the result's split.  Returns ``out``."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, got {type(out)}")
    if tuple(out.shape) != tuple(result.shape):
        raise ValueError(f"expected out shape {tuple(result.shape)}, got {tuple(out.shape)}")
    return out._adopt(result)


def sanitize_distribution(*args: DNDarray, target: DNDarray, diff_map=None):
    """Each input in the target's split (heat_tpu/core/sanitation.py:63): a
    resplit through the transport engine where the splits differ."""
    out = []
    for x in args:
        sanitize_in(x)
        out.append(x if x.split == target.split or x.ndim == 0 else x.resplit(target.split))
    return out[0] if len(out) == 1 else tuple(out)


def sanitize_infinity(x) -> Union[int, float]:
    """The largest value the dtype of ``x`` represents, for a DNDarray or a
    tensor: what stands in for infinity in integer contexts."""
    dtype = x.dtype.torch_type() if isinstance(x, DNDarray) else x.dtype
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).max)
    if dtype == torch.bool or dtype.is_complex:
        raise ValueError(f"{dtype} has no largest value")
    return int(torch.iinfo(dtype).max)


def sanitize_sequence(seq) -> list:
    """``seq`` as a list; raises unless it is a list or a tuple."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    raise TypeError(f"seq must be a list or a tuple, got {type(seq)}")


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Raise unless ``tensor`` has the shape of the array's first shard."""
    if tuple(tensor.shape) != tuple(array.lshape):
        raise ValueError(f"local tensor shape {tuple(tensor.shape)} != lshape {array.lshape}")


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d DNDarray as shape (1,), replicated; any other array as it is."""
    if x.ndim == 0:
        return DNDarray([x.shards[0].reshape(1)] * x.comm.size, (1,), x.dtype, None, x.device, x.comm)
    return x
