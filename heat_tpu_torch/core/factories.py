"""Array factories (counterpart of heat_tpu/core/factories.py): ``array``,
``asarray``, ``arange``, ``empty``, ``ones``, ``zeros``, ``full``, ``eye``,
``linspace``, ``logspace``, ``meshgrid``, the ``_like`` factories, and
``from_partitioned``/``from_partition_dict``.

A factory given data places it on the target device once and cuts it into
shard views; a factory given a shape builds each shard on the device at its
own size, so no global buffer exists: ``eye`` writes each shard's slice of
the diagonal, ``linspace`` computes each shard's points from their global
indices.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from . import devices, fusion, types
from .dndarray import DNDarray, _wrap
from ..parallel.mesh import MeshComm, sanitize_comm
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "from_partition_dict",
    "from_partitioned",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def array(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm: Optional[MeshComm] = None,
) -> DNDarray:
    """A DNDarray from array-like data (a DNDarray, torch tensor, numpy
    array, nested sequence or scalar), split along ``split``.  ``is_split``
    declares the data this process's chunk of an array split along that
    axis: in one process its chunk is the whole array; on a process comm
    the chunks' lengths are gathered, the global shape is their sum
    (heat_tpu/core/factories.py:105, ``make_array_from_process_local_data``),
    and a chunk that is not the chunk rule's for this process's positions
    raises.  With ``split`` every process gives the whole array and keeps
    its positions' shards.  Shards are row-major whatever ``order`` says."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    if is_split is not None:
        split = is_split
    comm = sanitize_comm(comm)
    if isinstance(obj, DNDarray):
        if split is None:
            split = obj.split
        if device is None:
            device = obj.device
        obj = obj.larray
    device = devices.sanitize_device(device)
    tt = types.canonical_heat_type(dtype).torch_type() if dtype is not None else None
    aliased = False
    if isinstance(obj, torch.Tensor):
        # row-major, as the kernels take it (a no-op for contiguous input)
        tensor = obj.detach().to(device=device.torch_device, dtype=tt, copy=copy).contiguous()
        aliased = not copy and tensor.untyped_storage().data_ptr() == obj.untyped_storage().data_ptr()
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
    if aliased:
        # the caller keeps the tensor and may write it: pending chains must
        # not read it after such a write
        fusion.expose((tensor,))
    if is_split is not None and comm.is_process_comm:
        return _from_process_chunks(tensor, is_split, device, comm)
    return _wrap(tensor, split, device, comm)


def _from_process_chunks(tensor: torch.Tensor, split: int, device, comm: MeshComm) -> DNDarray:
    """The array whose chunk along ``split`` in each process of ``comm`` is
    that process's ``tensor``: the chunks' shapes are all-reduced, their
    lengths summed into the global shape, and this process's chunk cut
    into its positions' shards."""
    from ..parallel import collectives

    split = sanitize_axis(tuple(tensor.shape), split)
    shapes = torch.zeros((comm.nprocs, tensor.ndim), dtype=torch.int64, device=tensor.device)
    shapes[comm.rank] = torch.tensor(tensor.shape, dtype=torch.int64)
    shapes = collectives.psum([shapes], comm=comm)[0].tolist()  # ht: HT002 ok — the chunks' shapes make the global shape
    others = {tuple(n for d, n in enumerate(sh) if d != split) for sh in shapes}
    if len(others) != 1:
        raise ValueError(f"process chunks disagree off the split axis {split}: {shapes}")
    gshape = list(tensor.shape)
    gshape[split] = sum(sh[split] for sh in shapes)
    gshape = tuple(gshape)
    local = comm.local_positions
    start = comm.chunk(gshape, split, rank=local[0])[0]
    want = sum(comm.chunk(gshape, split, rank=r)[1][split] for r in local)
    if tensor.shape[split] != want:
        raise ValueError(
            f"process {comm.rank}'s chunk has {tensor.shape[split]} rows along axis {split}, but the chunk rule "
            f"gives its positions {local} {want} of the global {gshape[split]}"
        )

    def cut(r):
        off, lshape, _ = comm.chunk(gshape, split, rank=r)
        return tensor.narrow(split, off - start, lshape[split])

    shards = comm.per_position(cut, gshape, split)
    return DNDarray(shards, gshape, types.canonical_heat_type(tensor.dtype), split, device, comm)


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
    tt = types.canonical_heat_type(dtype).torch_type()
    if len(range(0, math.ceil((stop - start) / step))) == 0:
        # an empty range, as numpy gives it (torch raises when the bounds
        # disagree with the step's sign)
        tensor = torch.empty(0, dtype=tt, device=device.torch_device)
    else:
        tensor = torch.arange(start, stop, step, dtype=tt, device=device.torch_device)
    return _wrap(tensor, split, device, sanitize_comm(comm))


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None, comm=None) -> DNDarray:
    """``obj`` as a DNDarray, copying only what must change: a DNDarray
    without a new dtype comes back as it is, a tensor already of the
    target device and dtype is taken without a copy."""
    if isinstance(obj, DNDarray) and dtype is None and is_split is None:
        return obj
    return array(obj, dtype=dtype, copy=False, order=order, is_split=is_split, device=device, comm=comm)


def _positions(shape, split, comm):
    """(rank, offset, local shape) of each position that holds a shard of
    its own; one entry for a replicated array."""
    if split is None:
        return [(0, 0, tuple(shape))]
    return [(r,) + comm.chunk(shape, split, rank=r)[:2] for r in range(comm.size)]


def _assemble(parts, shape, dtype, split, device, comm) -> DNDarray:
    shards = parts * comm.size if split is None else parts
    return DNDarray(shards, tuple(shape), dtype, split, device, comm)


def _factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    split = sanitize_axis(shape, split) if shape else None
    tdev, tt = device.torch_device, dtype.torch_type()
    parts = [fill(lshape, dtype=tt, device=tdev) for _, _, lshape in _positions(shape, split, comm)]
    return _assemble(parts, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Uninitialized array."""
    return _factory(shape, dtype, split, torch.empty, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones."""
    return _factory(shape, dtype, split, torch.ones, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Zeros."""
    return _factory(shape, dtype, split, torch.zeros, device, comm)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Uninitialized, with ``a``'s shape (and its dtype, split, device and
    mesh where those are not given)."""
    return _like(a, dtype, split, device, comm, empty)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, dtype, split, device, comm, ones)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, dtype, split, device, comm, zeros)


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, dtype, split, device, comm, lambda shape, **kw: full(shape, fill_value, **kw))


def _like(a, dtype, split, device, comm, factory) -> DNDarray:
    if isinstance(a, DNDarray):
        shape = a.shape
        dtype = a.dtype if dtype is None else dtype
        split = a.split if split is None else split
        device = a.device if device is None else device
        comm = a.comm if comm is None else comm
    else:
        arr = a if isinstance(a, torch.Tensor) else np.asarray(a)
        shape = tuple(arr.shape)
        dtype = types.canonical_heat_type(arr.dtype) if dtype is None else dtype
    return factory(shape, dtype=dtype, split=split, device=device, comm=comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Filled with ``fill_value``, cast to ``dtype`` (float32 when not
    given, as in heat_tpu)."""
    if dtype is None:
        dtype = types.float32
    value = fill_value.item() if hasattr(fill_value, "item") else fill_value

    def fill(lshape, dtype, device):
        return torch.empty(lshape, dtype=dtype, device=device).fill_(value)

    return _factory(shape, dtype, split, fill, device, comm)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order: str = "C") -> DNDarray:
    """The 2-D identity of ``shape`` (an int n, or (n, m)): each shard is
    built at its own size and gets the slice of the diagonal that crosses
    it, so no position ever holds more than its shard."""
    if order != "C":
        raise NotImplementedError("only C (row-major) order is supported")
    if isinstance(shape, (int, np.integer)):
        n = m = int(shape)
    else:
        shape = sanitize_shape(shape)
        n, m = (shape[0], shape[0]) if len(shape) == 1 else shape[:2]
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    split = sanitize_axis((n, m), split)
    parts = []
    for _, off, lshape in _positions((n, m), split, comm):
        t = torch.zeros(lshape, dtype=dtype.torch_type(), device=device.torch_device)
        t.diagonal(offset=off if split == 0 else -off).fill_(1)
        parts.append(t)
    return _assemble(parts, (n, m), dtype, split, device, comm)


def _inexact(dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point or dtype.is_complex else torch.float64


def _linspace_part(start: float, stop: float, num: int, endpoint: bool, lo: int, hi: int, ct: torch.dtype, dev):
    """Points [lo, hi) of heat_tpu's linspace (jnp.linspace's formula):
    ``start * (1 - i / div) + stop * (i / div)``, the endpoint itself last."""
    div = num - 1 if endpoint else num
    if num == 1:
        return torch.full((hi - lo,), start, dtype=ct, device=dev)
    i = torch.arange(lo, max(lo, min(hi, div)), dtype=ct, device=dev)
    # a true division: a host scalar divisor is a multiplication by its
    # reciprocal on the card
    step = i / torch.tensor(div, dtype=ct, device=dev)
    out = start * (1 - step) + stop * step
    if hi > div:  # the endpoint
        out = torch.cat([out, torch.full((hi - max(lo, div),), stop, dtype=ct, device=dev)])
    return out


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None, split=None, device=None, comm=None):
    """``num`` evenly spaced points over [start, stop] (without stop unless
    ``endpoint``), by heat_tpu's formula (jnp.linspace's, which differs
    from torch.linspace's); each shard computes its own points.  The
    default dtype is float64, heat_tpu's on the CPU.  ``retstep`` adds the
    spacing as a python float."""
    num = int(num)
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative.")
    dtype = types.float64 if dtype is None else types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    split = sanitize_axis((num,), split)
    tt = dtype.torch_type()
    ct = _inexact(tt)
    parts = []
    for _, off, (count,) in _positions((num,), split, comm):
        part = _linspace_part(float(start), float(stop), num, endpoint, off, off + count, ct, device.torch_device)
        if not (tt.is_floating_point or tt.is_complex):
            part = part.floor()
        parts.append(part.to(tt))
    result = _assemble(parts, (num,), dtype, split, device, comm)
    if retstep:
        return result, (float(stop) - float(start)) / max(num - (1 if endpoint else 0), 1)
    return result


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``base`` to the powers of :func:`linspace`'s points, per shard."""
    ct = torch.float64 if dtype is None else _inexact(types.canonical_heat_type(dtype).torch_type())
    lin = linspace(start, stop, num, endpoint=endpoint, dtype=ct, split=split, device=device, comm=comm)
    dtype = lin.dtype if dtype is None else types.canonical_heat_type(dtype)
    tt = dtype.torch_type()
    parts = [torch.pow(float(base), s).to(tt) for s in (lin.shards if lin.split is not None else lin.shards[:1])]
    return _assemble(parts, lin.shape, dtype, lin.split, lin.device, lin.comm)


def meshgrid(*arrays, indexing: str = "xy") -> List[DNDarray]:
    """Coordinate matrices from 1-D coordinate vectors.  Output i varies
    along the dimension of input i (the first two swapped for ``"xy"``)
    and is split along it when input i is split, as in heat_tpu; each
    position builds its own block from its chunk of the vector."""
    if not arrays:
        return []
    comm = next((a.comm for a in arrays if isinstance(a, DNDarray)), None)
    device = next((a.device for a in arrays if isinstance(a, DNDarray)), None)
    vecs = [a if isinstance(a, DNDarray) else array(a, device=device, comm=comm) for a in arrays]
    comm = sanitize_comm(comm)
    nd = len(vecs)
    lens = [v.size for v in vecs]
    swap = indexing == "xy" and nd >= 2
    shape = list(lens)
    if swap:
        shape[0], shape[1] = lens[1], lens[0]
    out = []
    for i, v in enumerate(vecs):
        dim = {0: 1, 1: 0}.get(i, i) if swap else i
        split = dim if v.split is not None else None
        local = v.shards if v.is_distributed() and v.comm.size == comm.size else None
        whole = None if local is not None else v.larray.reshape(-1)
        parts = []
        for r, off, lshape in _positions(tuple(shape), split, comm):
            t = local[r] if local is not None else whole.narrow(0, off, lshape[dim] if split is not None else lens[i])
            view = [1] * nd
            view[dim] = -1
            parts.append(t.reshape(view).expand(lshape).contiguous())
        out.append(_assemble(parts, tuple(shape), v.dtype, split, v.device, comm))
    return out


def from_partitioned(x, comm=None) -> DNDarray:
    """A DNDarray from an object exposing ``__partitioned__``."""
    return from_partition_dict(x.__partitioned__, comm=comm)


def from_partition_dict(parted: dict, comm=None) -> DNDarray:
    """A DNDarray from a partition-interface dict (heat_tpu/core/factories.py:357).
    Partitions whose data are torch tensors are taken as they are: as the
    shards themselves when they already follow the chunk rule over
    ``comm``, else joined on their device; no host round trip."""
    shape = tuple(parted["shape"])
    tiling = tuple(parted["partition_tiling"])
    split = next((i for i, t in enumerate(tiling) if t > 1), None)
    get = parted["get"]
    chunks = []
    for key in sorted(parted["partitions"].keys()):
        p = parted["partitions"][key]
        data = p["data"] if p.get("data") is not None else get(
            tuple(slice(s, s + n) for s, n in zip(p["start"], p["shape"]))
        )
        chunks.append(data)
    comm = sanitize_comm(comm)
    if all(isinstance(c, torch.Tensor) for c in chunks):
        device = devices.sanitize_device(chunks[0].device)
        if split is None:
            return array(chunks[0], split=None, copy=False, device=device, comm=comm)
        want = [int(row[split]) for row in comm.lshape_map(shape, split)]
        if len(chunks) == comm.size and [int(c.shape[split]) for c in chunks] == want \
                and len({c.device for c in chunks}) == 1:
            return DNDarray(list(chunks), shape, types.canonical_heat_type(chunks[0].dtype), split,
                            device, comm)
        return array(torch.cat(chunks, dim=split), split=split, copy=False, device=device, comm=comm)
    host = [c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c) for c in chunks]
    return array(host[0] if split is None else np.concatenate(host, axis=split), split=split, comm=comm)
