"""Array factories (counterpart of heat_tpu/core/factories.py): ``array``,
``arange``, ``empty``, ``ones``, ``zeros``.

A factory given data places it on the target device once and cuts it into
shard views; a factory given a shape builds each shard on the device at its
own size, so no global buffer exists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import devices, types
from .dndarray import DNDarray, _wrap
from ..parallel.mesh import MeshComm, sanitize_comm
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "empty", "ones", "zeros"]


def array(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    split: Optional[int] = None,
    device=None,
    comm: Optional[MeshComm] = None,
) -> DNDarray:
    """A DNDarray from array-like data (a DNDarray, torch tensor, numpy
    array, nested sequence or scalar), split along ``split``."""
    comm = sanitize_comm(comm)
    if isinstance(obj, DNDarray):
        if split is None:
            split = obj.split
        if device is None:
            device = obj.device
        obj = obj.larray
    device = devices.sanitize_device(device)
    tt = types.canonical_heat_type(dtype).torch_type() if dtype is not None else None
    if isinstance(obj, torch.Tensor):
        # row-major, as the kernels take it (a no-op for contiguous input)
        tensor = obj.detach().to(device=device.torch_device, dtype=tt, copy=copy).contiguous()
    else:
        # host data is copied once, into torch's own buffer
        host = np.asarray(obj)
        if host.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch does not read: take its bits
            tensor = torch.tensor(host.view(np.int16)).view(torch.bfloat16)
        else:
            tensor = torch.tensor(host)
        tensor = tensor.to(device=device.torch_device, dtype=tt)
    if tensor.ndim < ndmin:
        tensor = tensor.reshape((1,) * (ndmin - tensor.ndim) + tuple(tensor.shape))
    return _wrap(tensor, split, device, comm)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in [start, stop); the default dtype follows
    NumPy's (int64 for integer arguments, float64 otherwise)."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(f"arange takes 1-3 positional arguments, got {len(args)}")
    if dtype is None:
        dtype = np.result_type(start, stop, step)
    device = devices.sanitize_device(device)
    tensor = torch.arange(
        start, stop, step,
        dtype=types.canonical_heat_type(dtype).torch_type(),
        device=device.torch_device,
    )
    return _wrap(tensor, split, device, sanitize_comm(comm))


def _factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    split = sanitize_axis(shape, split) if shape else None
    tdev, tt = device.torch_device, dtype.torch_type()
    if split is None:
        shards = [fill(shape, dtype=tt, device=tdev)] * comm.size
    else:
        shards = [
            fill(comm.chunk(shape, split, rank=r)[1], dtype=tt, device=tdev)
            for r in range(comm.size)
        ]
    return DNDarray(shards, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uninitialized array."""
    return _factory(shape, dtype, split, torch.empty, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Ones."""
    return _factory(shape, dtype, split, torch.ones, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Zeros."""
    return _factory(shape, dtype, split, torch.zeros, device, comm)
