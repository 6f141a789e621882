"""The DNDarray: a global n-dimensional array split over mesh positions
(counterpart of heat_tpu/core/dndarray.py).

Where the JAX package holds one global ``jax.Array`` whose sharding places
the split dimension, here the array holds the global shape, dtype and split
plus one torch tensor per mesh position, cut by the chunk rule of
:meth:`MeshComm.chunk`.  A replicated array (``split=None``) holds the same
tensor at every position.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from .devices import Device
from .stride_tricks import sanitize_axis
from ..parallel import transport
from ..parallel.select import distributed_mask_select, distributed_pair_take
from ..parallel.mesh import MeshComm

__all__ = ["DNDarray", "LocalIndex"]


class LocalIndex:
    """Marker for indexing a shard directly (kept for the names' sake;
    :attr:`DNDarray.lloc` is the accessor)."""

    def __init__(self, obj):
        self.obj = obj


class _LlocAccessor:
    """The indexing proxy behind :attr:`DNDarray.lloc`: under the single
    controller the "local" data is the global array.  Reads return
    tensors; writes go through :meth:`DNDarray.__setitem__`."""

    def __init__(self, owner: "DNDarray"):
        self._owner = owner

    def __getitem__(self, key):
        return self._owner.larray[key]

    def __setitem__(self, key, value):
        self._owner[key] = value


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array.  numpy has no bfloat16 of its own:
    bfloat16 comes back as an ``ml_dtypes.bfloat16`` array of the same
    bits, and ``ml_dtypes`` is imported only here, when one is asked for."""
    # a tensor already on the host is copied: the array's later in-place
    # writes must not show through an earlier numpy result
    t = t.detach().cpu() if t.device.type != "cpu" else t.detach().clone()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError as err:
        raise ImportError("the numpy form of a bfloat16 array needs the ml_dtypes package") from err
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _shard(tensor: torch.Tensor, split: Optional[int], comm: MeshComm) -> List[torch.Tensor]:
    """Cut a global tensor into one shard per position (views, no copy)."""
    if split is None or tensor.ndim == 0:
        return [tensor] * comm.size
    out = []
    for r in range(comm.size):
        off, lshape, _ = comm.chunk(tuple(tensor.shape), split, rank=r)
        out.append(tensor.narrow(split, off, lshape[split]))
    return out


def _wrap(tensor: torch.Tensor, split: Optional[int], device: Device, comm: MeshComm) -> "DNDarray":
    """A DNDarray over a global tensor, cut for ``split``."""
    split = sanitize_axis(tuple(tensor.shape), split) if tensor.ndim else None
    return DNDarray(
        _shard(tensor, split, comm), tuple(tensor.shape),
        types.canonical_heat_type(tensor.dtype), split, device, comm,
    )


class DNDarray:
    """Distributed n-dimensional array over the positions of a MeshComm.

    Parameters
    ----------
    shards : sequence of torch.Tensor
        One tensor per mesh position, in position order.
    gshape : tuple of int
        Global shape.
    dtype : heat type
        Element type.
    split : int or None
        The dimension cut over the positions; ``None`` = replicated.
    device : Device
        Backend the shards live on.
    comm : MeshComm
        The positions.
    """

    def __init__(
        self,
        shards: Sequence[torch.Tensor],
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: MeshComm,
    ):
        if len(shards) != comm.size:
            raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
        self.__shards = list(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__halos = None

    # ------------------------------------------------------------ properties
    @property
    def shards(self) -> List[torch.Tensor]:
        """The per-position torch tensors, in position order."""
        return list(self.__shards)

    @property
    def larray(self) -> torch.Tensor:
        """The global tensor at its logical shape.  For a split array this
        concatenates the shards (a gather); per-position work reads
        :attr:`shards` instead."""
        if self.__split is None or self.__comm.size == 1:
            return self.__shards[0]
        return torch.cat(self.__shards, dim=self.__split)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    gshape = shape

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of the first position's shard."""
        return tuple(self.__shards[0].shape)

    @property
    def lshape_map(self) -> np.ndarray:
        """(positions, ndim) matrix of shard shapes."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> MeshComm:
        return self.__comm

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    gnumel = size

    @property
    def lnumel(self) -> int:
        """Elements of the first position's shard."""
        return int(np.prod(self.lshape, dtype=np.int64)) if self.lshape else 1

    @property
    def nbytes(self) -> int:
        """Bytes of the global array."""
        return self.size * self.__dtype.nbytes()

    gnbytes = nbytes

    @property
    def lnbytes(self) -> int:
        """Bytes of the first position's shard."""
        return self.lnumel * self.__dtype.nbytes()

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    @property
    def balanced(self) -> bool:
        """Always true: every array holds the chunk rule's layout."""
        return True

    def is_balanced(self, force_check: bool = False) -> bool:
        return True

    def balance_(self) -> "DNDarray":
        """A no-op: the chunk rule's layout is the balanced one."""
        return self

    def redistribute_(self, lshape_map=None, target_map=None) -> "DNDarray":
        """A no-op for the chunk rule's layout, the only one an array holds
        (heat_tpu/core/dndarray.py:508); any other ``target_map`` raises."""
        if target_map is not None and not np.array_equal(np.asarray(target_map), self.lshape_map):
            raise NotImplementedError(
                "arbitrary lshape maps are not representable; arrays always hold the chunk rule's layout"
            )
        return self

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        return self.lshape_map

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(counts, displacements) of the split dimension per position."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray. Cannot calculate counts and displacements.")
        counts = tuple(int(row[self.__split]) for row in self.lshape_map)
        displs = tuple(int(d) for d in np.concatenate(([0], np.cumsum(counts)[:-1])))
        return counts, displs

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.size > 1

    def stride(self) -> Tuple[int, ...]:
        """Element strides of the global array in C order, as
        ``torch.Tensor.stride()`` gives them."""
        strides, acc = [], 1
        for dim in reversed(self.__gshape):
            strides.append(acc)
            acc *= dim
        return tuple(reversed(strides))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Byte strides of the global array in C order, as numpy's."""
        return tuple(st * self.__dtype.nbytes() for st in self.stride())

    def copy(self) -> "DNDarray":
        """A copy: each shard copied where it lies (:func:`memory.copy`)."""
        from . import memory

        return memory.copy(self)

    def cpu(self) -> "DNDarray":
        """A copy on the host CPU over one position, keeping the split, as
        heat_tpu's lands on a one-device CPU mesh."""
        from .devices import cpu

        t = self.larray
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        return DNDarray([t], self.__gshape, self.__dtype, self.__split, cpu, MeshComm(1))

    def tolist(self, keepsplit: bool = False):
        """The global array as (nested) python lists."""
        return self.numpy().tolist()

    def transpose(self, axes=None) -> "DNDarray":
        from .linalg import basics

        return basics.transpose(self, axes)

    @property
    def lloc(self) -> _LlocAccessor:
        """Local-shard indexing: under the single controller the "local"
        view is the global array."""
        return _LlocAccessor(self)

    def fill_diagonal(self, value) -> "DNDarray":
        """Fill the main diagonal of a 2-D array in place and return it:
        each position writes the diagonal's slice that crosses its shard,
        which needs no mask or eye."""
        if self.ndim != 2:
            raise ValueError("Only 2D tensors supported at the moment")
        if isinstance(value, (DNDarray, torch.Tensor, np.ndarray)):
            value = value.item()
        for r, s in _distinct(self.__shards):
            if self.__split is None:
                s.diagonal().fill_(value)
            else:
                lo = self.__comm.chunk(self.__gshape, self.__split, rank=r)[0]
                s.diagonal(offset=lo if self.__split == 0 else -lo).fill_(value)
        self._invalidate_halos()
        return self

    # ---------------------------------------------------------------- halos
    def _invalidate_halos(self) -> None:
        """Drop the halos :meth:`get_halo` fetched: they hold until the next
        change of the data or the split."""
        self.__halos = None

    def get_halo(self, halo_size: int) -> None:
        """Fetch ``halo_size`` rows along the split axis from each position's
        neighbours (heat_tpu/core/dndarray.py:523): the last rows of the
        previous populated position and the first rows of the next
        (``ops.halo.exchange_halos``).  Read them with :meth:`shard_halos`,
        :attr:`halo_prev`/:attr:`halo_next` and :meth:`shard_with_halos`.
        An array that is not distributed, or a size of 0, fetches nothing."""
        if not isinstance(halo_size, int):
            raise TypeError(f"halo_size needs to be of Python type integer, {type(halo_size)} given")
        if halo_size < 0:
            raise ValueError(f"halo_size needs to be a positive Python integer, {halo_size} given")
        if not self.is_distributed() or halo_size == 0:
            return
        lmap = self.lshape_map[:, self.__split]
        populated = np.nonzero(lmap)[0]
        if len(populated) and (halo_size > lmap[populated]).any():
            raise ValueError(
                f"halo_size {halo_size} needs to be smaller than chunk-size {int(lmap[populated].min())} )"
            )
        from ..ops.halo import exchange_halos

        prev_all, next_all = exchange_halos(self, halo_size)
        self.__halos = (halo_size, prev_all, next_all, [int(r) for r in populated])

    def shard_halos(self, rank: int):
        """``(halo_prev, halo_next)`` of position ``rank`` after
        :meth:`get_halo`: ``None`` before it, at the first (prev) and last
        (next) populated position, and at positions without rows."""
        if self.__halos is None:
            return None, None
        _, prev_all, next_all, populated = self.__halos
        if rank not in populated:
            return None, None
        prev = None if rank == populated[0] else prev_all[rank].movedim(0, self.__split)
        nxt = None if rank == populated[-1] else next_all[rank].movedim(0, self.__split)
        return prev, nxt

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        """The calling position's halo from its previous neighbour (the
        single controller's position 0)."""
        return self.shard_halos(self.__comm.rank)[0]

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        """The calling position's halo from its next neighbour."""
        return self.shard_halos(self.__comm.rank)[1]

    @property
    def array_with_halos(self) -> torch.Tensor:
        """The calling position's shard with its halos attached
        (heat_tpu/core/dndarray.py:594)."""
        return self.shard_with_halos(self.__comm.rank)

    def shard_with_halos(self, rank: int) -> torch.Tensor:
        """Position ``rank``'s shard with the halos :meth:`get_halo` fetched
        concatenated along the split axis; a replicated array's data."""
        if self.__split is None:
            return self.__shards[0]
        prev, nxt = self.shard_halos(rank)
        parts = [p for p in (prev, self.__shards[rank], nxt) if p is not None]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.__split)

    @property
    def __partitioned__(self) -> dict:
        return self.create_partition_interface()

    def create_partition_interface(self) -> dict:
        """The partition interface (heat_tpu/core/dndarray.py:351): the
        global shape, the tiling of the split dimension, and per position
        its start, shape, location, dtype code and data, here the shard
        tensor itself; ``get(key)`` gives the tensor of a region."""
        nshards = self.__comm.size if self.__split is not None else 1
        partitions = {}
        for r in range(nshards):
            _, lshape, slices = self.__comm.chunk(self.__gshape, self.__split, rank=r)
            pos = tuple(r if i == self.__split else 0 for i in range(self.ndim))
            partitions[pos] = {
                "start": tuple(sl.start for sl in slices),
                "shape": lshape,
                "data": self.__shards[r],
                "location": [r],
                "dtype": self.__dtype.char(),
            }
        tiling = tuple(nshards if i == self.__split else 1 for i in range(self.ndim))
        return {
            "shape": self.__gshape,
            "partition_tiling": tiling,
            "partitions": partitions,
            "locals": list(partitions.keys()),
            "get": lambda key: self[key].larray if key is not None else None,
        }

    def __repr__(self) -> str:
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__

    # -------------------------------------------------------------- shards
    def lshards(self) -> List[np.ndarray]:
        """Per-position shard data as numpy arrays, in position order
        (heat_tpu/core/dndarray.py:333); a replicated array gives one."""
        if self.__split is None:
            return [self.numpy()]
        return [_host(s) for s in self.__shards]

    # ------------------------------------------------------------ conversion
    def numpy(self) -> np.ndarray:
        """Gather to a host numpy array; bfloat16 comes back as an
        ``ml_dtypes.bfloat16`` array of the same bits, as heat_tpu's does."""
        return _host(self.larray)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype``; ``copy=False`` casts in place of this array."""
        dtype = types.canonical_heat_type(dtype)
        tt = dtype.torch_type()
        if self.__split is None:
            shards = [self.__shards[0].to(tt, copy=copy)] * self.__comm.size
        else:
            shards = [s.to(tt, copy=copy) for s in self.__shards]
        if not copy:
            self.__shards = shards
            self.__dtype = dtype
            self._invalidate_halos()
            return self
        return DNDarray(shards, self.__gshape, dtype, self.__split, self.__device, self.__comm)

    def _adopt(self, result: "DNDarray") -> "DNDarray":
        """Take ``result``'s values, cast to this array's dtype, and its
        split (``sanitation.sanitize_out`` checks the shape first)."""
        tt = self.__dtype.torch_type()
        if result.split is None:
            self.__shards = [result.shards[0].to(tt)] * self.__comm.size
        else:
            self.__shards = [s.to(tt) for s in result.shards]
        self.__split = result.split
        self._invalidate_halos()
        return self

    def item(self):
        if self.size != 1:
            raise ValueError("only one-element arrays can be converted to Python scalars")
        return self.larray.reshape(()).item()

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __bool__(self) -> bool:
        return bool(self.item())

    # ----------------------------------------------------------- distribution
    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """In-place re-partition to a new split axis
        (heat_tpu/core/dndarray.py:450).  Axis-to-axis moves run through the
        transport engine (:func:`parallel.transport.tiled_resplit`): each new
        shard is assembled from views of the old ones, which are then
        released, so no gathered copy exists.  Moves to or from
        ``split=None`` gather and cut anew, as the JAX package keeps its
        ``device_put`` route for them."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        if transport.resplit_applicable(self.__gshape, self.__split, axis, self.__comm):
            shards = transport.tiled_resplit(self.__shards, self.__gshape, self.__split, axis, self.__comm)
        else:
            shards = _shard(self.larray, axis, self.__comm)
        self.__shards = shards
        self.__split = axis
        self._invalidate_halos()
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy of this array split along ``axis``."""
        out = DNDarray(
            self.__shards, self.__gshape, self.__dtype, self.__split, self.__device, self.__comm
        )
        return out.resplit_(axis)

    # ------------------------------------------------------------- indexing
    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __getitem__(self, key) -> "DNDarray":
        """Global indexing (heat_tpu/core/dndarray.py:1203).

        A boolean mask on the split dimension, or a full-``ndim`` mask of a
        split-0 array, runs through :func:`parallel.select.distributed_mask_select`;
        an integer array on the split dimension (optionally paired with one
        other integer array or int) through the transport engine's take.
        Neither gathers the input.  Basic keys (ints, slices, ``None``,
        ``...``) let the split follow its dimension: dropped dimensions
        shift it, an int on it leaves a replicated result, and a key that
        keeps the whole split dimension runs per shard.  Any other key is
        applied to the gathered array, with the split placed by NumPy's rule
        for the advanced block, and the result is cut anew."""
        routed = self.__mask_select_route(key)
        if routed is None:
            routed = self.__int_take_route(key)
        if routed is not None:
            return routed
        if not _is_basic(key):
            tkey, new_split, flips = _advanced_key(key, self.__gshape, self.__split, self.__shards[0].device)
            result = (self.larray.flip(flips) if flips else self.larray)[tkey]
            if result.ndim == 0 or (new_split is not None and new_split >= result.ndim):
                new_split = None
            return _wrap(result, new_split, self.__device, self.__comm)
        key = _basic_key(key, self.__gshape)
        split = self.__split
        new_split, in_dim, out_dim, whole = None, 0, 0, True
        flips, split_at, pos_key = [], None, []
        for pos, k in enumerate(key):
            pos_key.append(k)
            if k is None:
                out_dim += 1
                continue
            if in_dim == split:
                whole = isinstance(k, slice) and k == slice(None)
                new_split = out_dim if isinstance(k, slice) else None
                split_at = pos
            if isinstance(k, slice) and k.step is not None and k.step < 0:
                flips.append(out_dim)
                pos_key[-1] = _positive_step(k, self.__gshape[in_dim])
            out_dim += isinstance(k, slice)
            in_dim += 1
        if split is not None and split >= in_dim:
            new_split = out_dim + (split - in_dim)
        distributed = split is not None and self.__comm.size > 1
        if distributed and split_at is not None and new_split in flips:
            # the split axis is reversed: take its rows in the key's order
            # through the transport engine, which cuts the result by the
            # chunk rule, then apply the rest of the key per shard
            start, stop, step = key[split_at].indices(self.__gshape[split])
            count = len(range(start, stop, step))
            rows = start + step * torch.arange(count, dtype=torch.int64, device=self.__shards[0].device)
            gshape = list(self.__gshape)
            gshape[split] = int(rows.numel())
            taken = transport.tiled_take(self.__shards, rows, self.__gshape[split], split, self.__comm)
            rest = key[:split_at] + (slice(None),) + key[split_at + 1 :]
            return DNDarray(taken, tuple(gshape), self.__dtype, split, self.__device, self.__comm)[rest]
        # a negative step indexes its positive-step range, then flips it
        # (heat_tpu/core/dndarray.py:1237-1241)
        key = tuple(pos_key)

        def index(t: torch.Tensor) -> torch.Tensor:
            return t[key].flip(flips) if flips else t[key]

        if distributed and whole and new_split is not None:
            shards = [index(s) for s in self.__shards]
            gshape = list(shards[0].shape)
            gshape[new_split] = self.__gshape[split]
            return DNDarray(shards, tuple(gshape), self.__dtype, new_split, self.__device, self.__comm)
        result = index(self.larray)
        return _wrap(result, new_split if result.ndim else None, self.__device, self.__comm)

    def __mask_select_route(self, key) -> Optional["DNDarray"]:
        """Distributed boolean-mask selection (heat_tpu/core/dndarray.py:956):
        one boolean mask covering the split dimension, either 1-D on the
        split axis with every other position a full slice, or a full-``ndim``
        mask of a split-0 array.  ``None`` when the pattern does not apply."""
        if self.__split is None or not self.is_distributed():
            return None
        keys = key if isinstance(key, tuple) else (key,)
        keys = tuple(np.asarray(k) if isinstance(k, list) else k for k in keys)
        if any(k is None for k in keys):
            return None
        flatten = False
        if len(keys) == 1 and _is_bool_array(keys[0]) and _ndim(keys[0]) == self.ndim > 1:
            # full-ndim mask → flattened selection; the row-major flatten is
            # shard-contiguous only for split 0
            if self.__split != 0:
                return None
            mask = keys[0]
            if tuple(mask.shape) != self.__gshape:
                return None  # the generic path raises
            flatten = True
        else:
            if sum(1 for k in keys if k is Ellipsis) > 1:
                return None
            n_spec = sum(1 for k in keys if k is not Ellipsis)
            expanded = []
            for k in keys:
                if k is Ellipsis:
                    expanded.extend([slice(None)] * (self.ndim - n_spec))
                else:
                    expanded.append(k)
            if len(expanded) > self.ndim:
                return None
            mask = None
            for p, k in enumerate(expanded):
                if _is_bool_array(k) and _ndim(k) == 1:
                    if mask is not None:
                        return None
                    mask, mask_dim = k, p
                elif isinstance(k, slice) and k == slice(None):
                    continue
                else:
                    return None
            if mask is None or mask_dim != self.__split:
                return None
            if tuple(mask.shape)[0] != self.__gshape[self.__split]:
                return None  # the generic path raises

        comm = self.__comm
        tdev = self.__shards[0].device
        m_log = mask.larray if isinstance(mask, DNDarray) else torch.as_tensor(mask)
        m_log = m_log.to(device=tdev, dtype=torch.bool)
        # the count: one host read fixes the output's extent
        n_sel = int(m_log.sum())
        if flatten:
            gshape, out_split = (n_sel,), 0
        else:
            gs = list(self.__gshape)
            gs[self.__split] = n_sel
            gshape, out_split = tuple(gs), self.__split
        if n_sel == 0:
            # keep the split: the layout must not depend on the mask's data
            empty = torch.zeros(gshape, dtype=self.__dtype.torch_type(), device=tdev)
            return DNDarray(_shard(empty, out_split, comm), gshape, self.__dtype, out_split, self.__device, comm)
        shards = distributed_mask_select(
            self.__shards, _shard(m_log, 0, comm), self.__split, n_sel, comm, flatten=flatten
        )
        return DNDarray(shards, gshape, self.__dtype, out_split, self.__device, comm)

    def __int_take_route(self, key) -> Optional["DNDarray"]:
        """Distributed integer-array take (heat_tpu/core/dndarray.py:1059):
        ``x[rows]`` / ``x[rows, cols]`` with a 1-D integer array on the split
        dimension, optionally paired with ONE other 1-D integer array or int
        of the same length, every other position a full slice.  Host rows
        (numpy, lists) out of bounds raise; device rows (tensors, integer
        DNDarrays) are clamped to the extent, as jax's device keys are.
        ``None`` when the pattern does not apply."""
        if self.__split is None or not self.is_distributed():
            return None
        keys = key if isinstance(key, tuple) else (key,)
        keys = tuple(
            np.asarray(k) if isinstance(k, list) else (k.larray if isinstance(k, DNDarray) else k) for k in keys
        )
        if sum(1 for k in keys if k is Ellipsis) > 1:
            return None
        n_spec = sum(1 for k in keys if k is not Ellipsis)
        expanded = []
        for k in keys:
            if k is Ellipsis:
                expanded.extend([slice(None)] * (self.ndim - n_spec))
            else:
                expanded.append(k)
        if len(expanded) > self.ndim:
            return None
        expanded += [slice(None)] * (self.ndim - len(expanded))

        def is_host_int_arr(k):
            return isinstance(k, np.ndarray) and k.ndim == 1 and np.issubdtype(k.dtype, np.integer)

        def is_dev_int_arr(k):
            return isinstance(k, torch.Tensor) and k.ndim == 1 and _is_int_dtype(k.dtype)

        rows = None
        pair = None  # (position, cols array or int)
        for p, k in enumerate(expanded):
            if isinstance(k, slice):
                if k != slice(None):
                    return None
                continue
            if p == self.__split and (is_host_int_arr(k) or is_dev_int_arr(k)):
                rows = k
            elif p != self.__split and pair is None and (
                is_host_int_arr(k) or (isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_)))
            ):
                pair = (p, k)
            else:
                return None
        if rows is None:
            return None

        split = self.__split
        comm = self.__comm
        n_axis = self.__gshape[split]
        tdev = self.__shards[0].device
        if isinstance(rows, torch.Tensor):
            rows_n = _clamp_index(rows.to(tdev), n_axis)
        else:
            rows_n = torch.from_numpy(_host_index(rows, n_axis)).to(tdev)
        L = int(rows_n.shape[0])
        if L == 0:
            return None  # empty selection: the generic path handles it

        # validate the pair before moving anything: a broadcast-shaped cols
        # key takes the generic path without a discarded take
        cols_n = None
        if pair is not None:
            p2, cols = pair
            cols_arr = np.full((L,), int(cols), np.int64) if isinstance(cols, (int, np.integer)) else np.asarray(cols)
            if cols_arr.shape != (L,):
                return None
            cols_n = torch.from_numpy(_host_index(cols_arr, self.__gshape[p2]))

        shards = transport.tiled_take(self.__shards, rows_n, n_axis, split, comm)
        if pair is None:
            gs = list(self.__gshape)
            gs[split] = L
            return DNDarray(shards, tuple(gs), self.__dtype, split, self.__device, comm)
        shards = distributed_pair_take(shards, cols_n, split, p2, comm)
        # NumPy's block placement: a contiguous pair sits at min(split, p2);
        # a slice between the keys pushes the block to the front
        bp = min(split, p2) if abs(split - p2) == 1 else 0
        t_after = split - (1 if p2 < split else 0)
        if t_after != bp:
            shards = [s.movedim(t_after, bp) for s in shards]
        out_dims = [self.__gshape[d] for d in range(self.ndim) if d not in (split, p2)]
        out_dims.insert(bp, L)
        return DNDarray(shards, tuple(out_dims), self.__dtype, bp, self.__device, comm)

    # ----------------------------------------------------------- assignment
    def __setitem__(self, key, value) -> None:
        """Global assignment (heat_tpu/core/dndarray.py:1262): every key
        form :meth:`__getitem__` takes, a value that is a scalar, a tensor,
        an ndarray or a DNDarray, cast to this array's dtype and broadcast
        as numpy does.  Each position writes only into its own shard, in
        place.  Host integer keys out of bounds raise; device integer keys
        (tensors, integer DNDarrays) are clamped to the extent, as
        heat_tpu's are.  Of duplicate indices one write wins, which one is
        not defined (as in XLA's scatter).

        Routes: a boolean mask on the split dimension (or a full mask of a
        split-0 array) assigns each position's selected elements the value
        rows that the exclusive prefix of the per-position counts gives
        them; basic keys let each position write its intersection with the
        key; any other key writes, per position, the elements of the
        broadcast index block that it owns.  A value split along the
        region's split dimension is never gathered: each position reads
        the value rows it receives from the value shards that hold them,
        by K7 (:func:`parallel.transport.rechunk_rows`) where the region's
        rows lead its layout, straight into the shard where they are
        contiguous there."""
        keys = _assign_key(key, self.__gshape)
        scalar_bools = [k for k in keys if _is_scalar_bool_key(k)]
        if scalar_bools:
            if any(_is_array(k) or isinstance(k, DNDarray) for k in keys if not _is_scalar_bool_key(k)):
                raise IndexError("an assignment cannot mix scalar boolean keys with array keys")
            if not all(bool(k) for k in scalar_bools):
                return  # numpy: a False key selects nothing
            keys = tuple(None if _is_scalar_bool_key(k) else k for k in keys)
        value = self.__assign_value(value)
        self._invalidate_halos()
        if not self.__mask_assign(keys, value):
            self.__put(keys, value)

    def __assign_value(self, value):
        """The value as a tensor of this array's dtype on its device, or as
        a DNDarray of that dtype distributed over this mesh; a value that
        shares memory with this array is copied first."""
        tdev, tt = self.__shards[0].device, self.__dtype.torch_type()
        if isinstance(value, DNDarray):
            if value.is_distributed() and value.comm.size == self.__comm.size:
                if value.dtype is not self.__dtype:
                    value = value.astype(self.__dtype)
                shards = [sh if sh.device == tdev else sh.to(tdev) for sh in value.shards]
                if any(_shares(sh, self.__shards) for sh in shards):
                    shards = [sh.clone() for sh in shards]
                return DNDarray(shards, value.shape, value.dtype, value.split, self.__device, self.__comm)
            value = value.larray
        if isinstance(value, np.generic):
            value = value.item()
        if isinstance(value, torch.Tensor):
            t = value.detach().to(device=tdev, dtype=tt)
        elif isinstance(value, (bool, int, float, complex)):
            t = torch.tensor(value).to(device=tdev, dtype=tt)
        else:
            host = np.asarray(value)
            if host.dtype.name == "bfloat16":
                t = torch.from_numpy(host.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(host))
            t = t.to(device=tdev, dtype=tt)
        return t.clone() if _shares(t, self.__shards) else t

    def __positions(self):
        """(rank, shard, lo, hi) of each distinct shard: its rows of the
        split dimension; one entry covering everything when the array is
        not distributed."""
        if not self.is_distributed():
            n = self.__gshape[self.__split] if self.__split is not None else 0
            return [(0, self.__shards[0], 0, n)]
        out = []
        for r, shard in _distinct(self.__shards):
            lo = self.__comm.chunk(self.__gshape, self.__split, rank=r)[0]
            out.append((r, shard, lo, lo + shard.shape[self.__split]))
        return out

    def __mask_assign(self, keys, value) -> bool:
        """The mask route: one boolean array key, 1-D on the split
        dimension (every other key a full slice), or covering every
        dimension of a split-0 array (any split for a one-element value).
        False when the key is another form."""
        arrays = [(p, k) for p, k in enumerate(keys) if not (k is None or isinstance(k, (int, slice)))]
        if len(arrays) != 1 or any(k is None for k in keys):
            return False
        p, mask = arrays[0]
        if not _is_bool_dtype(mask):
            return False
        nd = _ndim(mask)
        if any(k != slice(None) for q, k in enumerate(keys) if q != p):
            return False
        distributed = self.is_distributed()
        split = self.__split
        flatten = nd == self.ndim > 1
        scalar = isinstance(value, torch.Tensor) and value.numel() == 1
        if flatten:
            if distributed and split != 0 and not scalar:
                return False
            if tuple(mask.shape) != self.__gshape:
                raise IndexError(f"boolean index shape {tuple(mask.shape)} does not match the array's {self.__gshape}")
            along = split if distributed else 0
        else:
            if nd != 1 or (distributed and p != split):
                return False
            if tuple(mask.shape)[0] != self.__gshape[p]:
                raise IndexError(f"boolean index of {tuple(mask.shape)[0]} does not match dimension {p} of {self.__gshape[p]}")
            along = 0
        tdev = self.__shards[0].device
        positions = self.__positions()
        if distributed and isinstance(mask, DNDarray) and mask.is_distributed() and mask.split == along \
                and mask.comm.size == self.__comm.size:
            pieces = {r: mask.shards[r].to(device=tdev) for r, *_ in positions}
        else:
            whole = (mask.larray if isinstance(mask, DNDarray) else torch.as_tensor(mask)).to(device=tdev, dtype=torch.bool)
            pieces = {r: whole.narrow(along, lo, hi - lo) if distributed else whole for r, _, lo, hi in positions}
        if scalar:
            fill = value.reshape(())
            for r, shard, _, _ in positions:
                m = pieces[r]
                if not flatten:
                    m = m.reshape([-1 if d == p else 1 for d in range(self.ndim)])
                shard.masked_fill_(m, fill)
            return True
        counts = torch.stack([pieces[r].sum() for r, *_ in positions]).tolist()  # one host read
        starts = np.concatenate(([0], np.cumsum(counts)[:-1])).tolist()
        n_sel = int(sum(counts))
        full_shape = (n_sel,) if flatten else self.__gshape[:p] + (n_sel,) + self.__gshape[p + 1 :]
        labels = [("dim", d) for d in range(len(full_shape))]
        dim = 0 if flatten else p
        src = _value_source(value, full_shape, labels, labels, labels[dim], ())

        def index(m):
            return m if flatten else (slice(None),) * p + (m,)

        by_k7 = distributed and dim == 0 and _rows_contiguous(src, full_shape)
        for i, (r, shard, _, _) in enumerate(positions):
            if counts[i]:
                a, b = starts[i], starts[i] + counts[i]
                shard[index(pieces[r])] = _k7_rows(src, r, a, b, self.__comm) if by_k7 else src.range(a, b)
        return True

    def __put(self, keys, value) -> None:
        """Every key but the mask route's: ints, slices, ``None`` and
        integer arrays (masks as their nonzero indices).  Each position
        writes what of the region lies in its shard: a slice's run of rows
        on the split dimension (K7 re-cuts a split value there), an int's
        one row, or the elements of the broadcast index block it owns."""
        gshape, split = self.__gshape, self.__split
        distributed = self.is_distributed()
        tdev = self.__shards[0].device
        keys = _bools_to_indices(tuple(k.larray if isinstance(k, DNDarray) else k for k in keys), gshape)
        comps, in_dim, flips = [], 0, []
        for k in keys:
            if k is None:
                comps.append(None)
                continue
            n = gshape[in_dim]
            if isinstance(k, slice):
                if k.indices(n)[2] < 0:
                    flips.append(("dim", in_dim))
                    k = _positive_step(k, n)
                comps.append(slice(*k.indices(n)))
            elif isinstance(k, int):
                if not -n <= k < n:
                    raise IndexError(f"index {k} is out of bounds for dimension {in_dim} with size {n}")
                comps.append(k % n)
            elif isinstance(k, torch.Tensor):
                comps.append(_clamp_index(k.to(tdev), n))
            else:
                comps.append(torch.from_numpy(_host_index(k, n)).reshape(k.shape).to(tdev))
            in_dim += 1
        arrays = [c.shape for c in comps if isinstance(c, torch.Tensor)]
        block = tuple(np.broadcast_shapes(*arrays)) if arrays else None
        full_labels, full_shape = _layout(comps, block)
        core = [c for c in comps if c is not None]
        core_labels, core_shape = _layout(core, block)
        # ints of a block as tensors of its shape, so that torch places the
        # block where numpy does
        core = [torch.full(block, c, dtype=torch.int64, device=tdev) if block and isinstance(c, int) else c
                for c in core]
        kind = [c for c in comps if c is not None][split] if distributed else None
        if not isinstance(kind, (slice, torch.Tensor)):
            # replicated, or one int on the split dimension: one writer
            src = _value_source(value, full_shape, full_labels, core_labels, None, flips)
            for _, shard, lo, hi in self.__positions():
                local = list(core)
                if distributed:
                    if not lo <= kind < hi:
                        continue
                    local[split] = local[split] - lo
                shard[tuple(local)] = src
            return
        if isinstance(kind, slice):
            src = _value_source(value, full_shape, full_labels, core_labels, ("dim", split), flips)
            by_k7 = split == 0 and _rows_contiguous(src, core_shape)
            # whole rows at step 1 lie contiguous in a shard: K7 writes there
            whole_rows = by_k7 and kind.step == 1 and all(
                c == slice(0, gshape[d], 1) for d, c in enumerate(core) if d != split)
            for r, shard, lo, hi in self.__positions():
                k0, k1, local_rows = _span(kind, lo, hi)
                if k1 <= k0:
                    continue
                if whole_rows and shard.is_contiguous():
                    _k7_rows(src, r, k0, k1, self.__comm, out=shard[local_rows])
                    continue
                local = list(core)
                local[split] = local_rows
                shard[tuple(local)] = _k7_rows(src, r, k0, k1, self.__comm) if by_k7 else src.range(k0, k1)
            return
        # the split dimension is indexed by an array of the block: merge the
        # block's dimensions into one, then each position takes its elements
        src = _value_source(value, full_shape, full_labels, core_labels, ("blk", 0), flips, merge=len(block))
        flat = [c.expand(block).reshape(-1) if isinstance(c, torch.Tensor) else c for c in core]
        for _, shard, lo, hi in self.__positions():
            sel = torch.nonzero((flat[split] >= lo) & (flat[split] < hi)).reshape(-1)
            if sel.numel() == 0:
                continue
            local = [c.index_select(0, sel) if isinstance(c, torch.Tensor) else c for c in flat]
            local[split] = local[split] - lo
            shard[tuple(local)] = src.take(sel)

    @property
    def T(self) -> "DNDarray":
        """The transpose (all axes reversed)."""
        from .linalg import basics

        return basics.transpose(self)


def _basic_key(key, shape: Tuple[int, ...]) -> tuple:
    """``key`` as a tuple of ints, slices and ``None`` with ``...``
    expanded; ints are bounds-checked and made non-negative."""
    if not isinstance(key, tuple):
        key = (key,)
    for k in key:
        if not (k is None or k is Ellipsis or isinstance(k, (int, np.integer, slice))) or isinstance(k, bool):
            raise TypeError(f"a basic key holds ints, slices, None and ..., got {type(k)}")
    consumed = sum(1 for k in key if k is not None and k is not Ellipsis)
    if consumed > len(shape):
        raise IndexError(f"too many indices: array is {len(shape)}-D, got {consumed}")
    if sum(1 for k in key if k is Ellipsis) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if any(k is Ellipsis for k in key):
        e = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:e] + (slice(None),) * (len(shape) - consumed) + key[e + 1 :]
    out, dim = [], 0
    for k in key:
        if isinstance(k, (int, np.integer)):
            n = shape[dim]
            if not -n <= int(k) < n:
                raise IndexError(f"index {int(k)} is out of bounds for dimension {dim} with size {n}")
            k = int(k) % n
        out.append(k)
        dim += k is not None
    return tuple(out)


def _positive_step(k: slice, n: int) -> slice:
    """The positive-step slice over the elements that ``k``, of negative
    step, selects from an extent ``n``: reversed, they are ``k``'s."""
    start, stop, step = k.indices(n)
    count = len(range(start, stop, step))
    if count == 0:
        return slice(0, 0, 1)
    return slice(start + (count - 1) * step, start + 1, -step)


def _is_array(k) -> bool:
    return isinstance(k, (np.ndarray, torch.Tensor))


def _ndim(k) -> int:
    return k.ndim if isinstance(k, (np.ndarray, torch.Tensor, DNDarray)) else np.ndim(k)


def _is_bool_dtype(k) -> bool:
    if isinstance(k, DNDarray):
        return k.dtype is types.bool
    if isinstance(k, torch.Tensor):
        return k.dtype == torch.bool
    return isinstance(k, np.ndarray) and k.dtype == np.bool_


def _is_bool_array(k) -> bool:
    """A boolean mask of at least one dimension."""
    return isinstance(k, (np.ndarray, torch.Tensor, DNDarray)) and _ndim(k) >= 1 and _is_bool_dtype(k)


def _is_int_dtype(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def _is_scalar_bool_key(k) -> bool:
    """A 0-d mask key: python bool, np.bool_, or a 0-d boolean array
    (heat_tpu/core/dndarray.py:113)."""
    if isinstance(k, (bool, np.bool_)):
        return True
    return _is_array(k) and k.ndim == 0 and _is_bool_dtype(k)


def _is_basic(key) -> bool:
    """True iff ``key`` holds only ints, slices, ``None`` and ``...``."""
    keys = key if isinstance(key, tuple) else (key,)
    return all(
        k is None or k is Ellipsis or isinstance(k, slice)
        or (isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_)))
        for k in keys
    )


def _host_index(ka: np.ndarray, n: int) -> np.ndarray:
    """A host integer key bounds-checked against ``n`` and made
    non-negative, as int64."""
    ka = np.asarray(ka)
    if ka.size and (int(ka.min()) < -n or int(ka.max()) >= n):
        raise IndexError(f"index array with values in [{int(ka.min())}, {int(ka.max())}] is out of bounds for size {n}")
    return np.where(ka < 0, ka + n, ka).astype(np.int64)


def _clamp_index(k: torch.Tensor, n: int) -> torch.Tensor:
    """A device integer key with negatives shifted, then clamped to
    ``[0, n)``: jax's semantics for device keys, with no host read."""
    k = k.to(torch.int64)
    return torch.where(k < 0, k + n, k).clamp(0, max(n - 1, 0))


def _bools_to_indices(key: tuple, gshape: Tuple[int, ...]) -> tuple:
    """Boolean array keys replaced by their nonzero index arrays (NumPy's
    ``x[m, j] == x[m.nonzero()[0], j]``; heat_tpu/core/dndarray.py:809)."""
    out, in_dim = [], 0
    for k in key:
        if k is None or _is_scalar_bool_key(k):
            out.append(k)
            continue
        if _is_array(k) and k.ndim > 0 and _is_bool_dtype(k):
            mk = k.cpu().numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
            want = gshape[in_dim : in_dim + mk.ndim]
            if tuple(mk.shape) != tuple(want):
                raise IndexError(f"boolean index shape {tuple(mk.shape)} does not match indexed dims {tuple(want)}")
            out.extend(np.nonzero(mk))
            in_dim += mk.ndim
        else:
            out.append(k)
            in_dim += 1
    return tuple(out)


def _advanced_split(key: tuple, split: int) -> Optional[int]:
    """The result's split under advanced indexing, by NumPy's placement
    rule for the broadcast advanced block (heat_tpu/core/dndarray.py:854):
    a 1-D array on the split axis alone keeps it; a block that consumes the
    split dimension is split along its first output dimension; otherwise
    the split dimension survives as a sliced dimension at its output
    position."""

    def is_arr(k):
        return _is_array(k) and k.ndim > 0

    in_dim = 0
    adv_hits_split = False
    block_positions = []
    bcast_nd = 0
    only_split_1d = True
    for pos, k in enumerate(key):
        if k is None:
            continue
        if _is_scalar_bool_key(k):
            only_split_1d = False
            block_positions.append(pos)
            continue
        if is_arr(k):
            if in_dim == split:
                adv_hits_split = True
                if k.ndim != 1:
                    only_split_1d = False
            else:
                only_split_1d = False
            block_positions.append(pos)
            bcast_nd = max(bcast_nd, k.ndim)
            in_dim += 1
        elif isinstance(k, slice):
            if not (k.start is None and k.stop is None and k.step is None):
                only_split_1d = False
            in_dim += 1
        else:  # integer: joins the advanced block, contributes no dim
            only_split_1d = False
            block_positions.append(pos)
            if in_dim == split:
                adv_hits_split = True
            in_dim += 1
    lo, hi = min(block_positions), max(block_positions)
    contiguous = all(p in block_positions for p in range(lo, hi + 1))
    if adv_hits_split:
        if only_split_1d:
            return split
        if not contiguous:
            return 0  # NumPy moves the block to the front
        out_pos = 0
        for pos, k in enumerate(key):
            if pos == lo:
                break
            if k is None or isinstance(k, slice):
                out_pos += 1
        return out_pos
    # the split dimension survives as a sliced dimension
    out_pos = 0 if contiguous else bcast_nd
    in_cursor = 0
    block_done = not contiguous
    for pos, k in enumerate(key):
        if k is None:
            out_pos += 1
            continue
        if _is_scalar_bool_key(k):
            if not block_done and pos == lo:
                out_pos += bcast_nd
                block_done = True
            continue
        if isinstance(k, slice) and not is_arr(k):
            if in_cursor == split:
                return out_pos
            out_pos += 1
            in_cursor += 1
            continue
        if not block_done and pos == lo:
            out_pos += bcast_nd
            block_done = True
        in_cursor += 1
    return out_pos + (split - in_cursor)


def _advanced_key(key, gshape: Tuple[int, ...], split: Optional[int], device) -> Tuple[tuple, Optional[int], List[int]]:
    """A key that is not basic as a torch key for the gathered tensor, the
    result's split (heat_tpu/core/dndarray.py:688), and the dimensions to
    flip before the key applies (those of its negative-step slices).  Host
    integer keys are bounds-checked; device integer keys are clamped; masks
    become their nonzero index arrays."""
    ndim = len(gshape)
    if isinstance(key, DNDarray):
        key = key.larray
    if isinstance(key, list):
        key = np.asarray(key)
    if not isinstance(key, tuple):
        key = (key,)
    else:
        key = tuple(k.larray if isinstance(k, DNDarray) else np.asarray(k) if isinstance(k, list) else k for k in key)
    key = tuple(bool(k) if isinstance(k, np.bool_) else k for k in key)

    def consumed(k):
        if k is None or k is Ellipsis or _is_scalar_bool_key(k):
            return 0
        if _is_array(k) and k.ndim > 0 and _is_bool_dtype(k):
            return k.ndim
        return 1

    n_spec = sum(consumed(k) for k in key)
    if any(k is Ellipsis for k in key):
        e = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:e] + (slice(None),) * (ndim - n_spec) + key[e + 1 :]
    if n_spec > ndim:
        raise IndexError(f"too many indices: array is {ndim}-D, got {n_spec}")
    advanced = any(_is_array(k) and k.ndim > 0 for k in key)
    if advanced and any(_is_array(k) and k.ndim > 0 and _is_bool_dtype(k) for k in key):
        key = _bools_to_indices(key, gshape)
    if split is None:
        new_split = None
    elif advanced:
        new_split = _advanced_split(key, split)
    else:  # scalar bools among basic keys: each adds a dimension
        new_split, in_dim, out_dim = None, 0, 0
        for k in key:
            if k is None or _is_scalar_bool_key(k):
                out_dim += 1
                continue
            if isinstance(k, slice) and in_dim == split:
                new_split = out_dim
            out_dim += isinstance(k, slice)
            in_dim += 1
        if split >= in_dim:
            new_split = out_dim + (split - in_dim)
    out, dim, flips = [], 0, []
    for k in key:
        if k is None or _is_scalar_bool_key(k):
            out.append(bool(k) if k is not None else None)
            continue
        n = gshape[dim] if dim < ndim else 0
        if isinstance(k, slice):
            if k.step is not None and k.step < 0:
                # flip the dimension first: the same elements then lie at
                # a positive step, in the key's order
                flips.append(dim)
                p = _positive_step(k, n)
                k = slice(n - p.stop, n - p.start, p.step)
            out.append(k)
        elif isinstance(k, torch.Tensor) and _is_int_dtype(k.dtype):
            out.append(_clamp_index(k.to(device), n) if k.ndim else int(k))
        elif isinstance(k, (int, np.integer)) or (isinstance(k, np.ndarray) and np.issubdtype(k.dtype, np.integer)):
            out.append(torch.from_numpy(np.atleast_1d(_host_index(k, n))).reshape(np.shape(k)).to(device)
                       if np.ndim(k) else int(_host_index(k, n)))
        else:
            raise TypeError(f"a DNDarray cannot be indexed by {type(k)}")
        dim += 1
    return tuple(out), new_split, flips


def _distinct(shards: Sequence[torch.Tensor]):
    """(position, shard) for each distinct tensor object, in position order:
    a replicated array's one tensor once."""
    seen = set()
    for r, t in enumerate(shards):
        if id(t) not in seen:
            seen.add(id(t))
            yield r, t


def _shares(t: torch.Tensor, shards: Sequence[torch.Tensor]) -> bool:
    """Whether ``t`` lies in the memory of one of ``shards``."""
    if t.numel() == 0:
        return False
    ptr = t.untyped_storage().data_ptr()
    return any(s.numel() and s.untyped_storage().data_ptr() == ptr for s in shards)


def _assign_key(key, shape: Tuple[int, ...]) -> tuple:
    """An assignment key as a tuple over every dimension: ``...`` expanded
    and trailing dimensions filled with full slices; lists become arrays,
    numpy scalars and 0-d integer arrays python scalars, integer
    DNDarrays their tensor; boolean DNDarrays stay (the mask route reads
    their shards)."""
    if not isinstance(key, tuple):
        key = (key,)
    out = []
    for k in key:
        if isinstance(k, DNDarray) and k.dtype is not types.bool:
            k = k.larray
        elif isinstance(k, list):
            k = np.asarray(k)
        if isinstance(k, np.bool_):
            k = bool(k)
        elif isinstance(k, np.integer):
            k = int(k)
        elif isinstance(k, (np.ndarray, torch.Tensor)) and k.ndim == 0:
            if _is_bool_dtype(k):
                k = bool(k)
            elif isinstance(k, np.ndarray) and np.issubdtype(k.dtype, np.integer) or \
                    isinstance(k, torch.Tensor) and _is_int_dtype(k.dtype):
                k = int(k)
        ok = k is None or k is Ellipsis or isinstance(k, (bool, int, slice)) or (
            isinstance(k, (np.ndarray, torch.Tensor, DNDarray)) and (_is_bool_dtype(k) or (
                np.issubdtype(k.dtype, np.integer) if isinstance(k, np.ndarray) else
                isinstance(k, torch.Tensor) and _is_int_dtype(k.dtype))))
        if not ok:
            raise TypeError(f"a DNDarray cannot be indexed by {type(k)}")
        out.append(k)

    def consumed(k):
        if k is None or k is Ellipsis or isinstance(k, bool):
            return 0
        return _ndim(k) if _is_bool_array(k) else 1

    n_spec = sum(consumed(k) for k in out)
    if n_spec > len(shape):
        raise IndexError(f"too many indices: array is {len(shape)}-D, got {n_spec}")
    ellipses = [i for i, k in enumerate(out) if k is Ellipsis]
    if len(ellipses) > 1:
        raise IndexError("an index can only have a single ellipsis")
    fill = [slice(None)] * (len(shape) - n_spec)
    if ellipses:
        return tuple(out[: ellipses[0]] + fill + out[ellipses[0] + 1 :])
    return tuple(out + fill)


def _k7_rows(src, r: int, a: int, b: int, comm, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows [a, b) of the split value ``src`` for position ``r``: one K7
    call (more where more value chunks cover them) into ``out`` or a new
    piece-sized buffer, so one position's piece exists at a time."""
    bounds = [(0, 0)] * comm.size
    bounds[r] = (a, b)
    outs = [None] * comm.size
    outs[r] = out
    return transport.rechunk_rows(src.shards, bounds, comm, out=outs)[r]


def _rows_contiguous(src, shape) -> bool:
    """Whether K7 can move ``src``'s rows: split shards laid along the
    region's leading dimension, read forwards, each contiguous (no
    broadcast dimension)."""
    return (
        isinstance(src, transport.RowSource) and src.shards is not None and not src.reverse and src.dim == 0
        and all(s.is_contiguous() and tuple(s.shape[1:]) == tuple(shape[1:]) for s in src.shards)
    )


def _broadcast_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` broadcast to ``shape`` as numpy's assignment does (leading
    dimensions of extent 1 dropped first); raises ``ValueError``."""
    shape = tuple(shape)
    while t.ndim > len(shape) and t.shape[0] == 1:
        t = t[0]
    try:
        return t.broadcast_to(shape)
    except RuntimeError:
        raise ValueError(f"could not broadcast input array from shape {tuple(t.shape)} into shape {shape}") from None


def _layout(comps, block: Optional[Tuple[int, ...]]):
    """Labels and extents of the dimensions of ``x[comps]`` by numpy's rule
    (ints, positive-step slices, ``None`` and integer tensors broadcasting
    to ``block``): ``("blk", j)`` for the index block (where its arrays and
    ints stand when they are adjacent, else first), ``("dim", d)`` for a
    slice of dimension d, ``("new", i)`` for ``None`` at key position i."""
    adv = [i for i, c in enumerate(comps) if isinstance(c, torch.Tensor) or (block is not None and isinstance(c, int))]
    adjacent = not adv or adv == list(range(adv[0], adv[-1] + 1))
    blk = [("blk", j) for j in range(len(block or ()))]
    labels, ext = ([] if adjacent else list(blk)), ([] if adjacent else list(block))
    in_dim = 0
    for i, c in enumerate(comps):
        if c is None:
            labels.append(("new", i))
            ext.append(1)
            continue
        if i in adv:
            if adjacent and i == adv[0]:
                labels += blk
                ext += list(block)
        elif isinstance(c, slice):
            labels.append(("dim", in_dim))
            ext.append(len(range(c.start, c.stop, c.step)))
        in_dim += 1
    return labels, tuple(ext)


def _span(sl: slice, lo: int, hi: int):
    """(k0, k1, local slice): the entries k0 .. k1 - 1 of the positive-step
    slice ``sl`` that fall in a position's rows [lo, hi), and where they
    lie in its shard."""
    cnt = len(range(sl.start, sl.stop, sl.step))
    k0 = min(max(0, -(-(lo - sl.start) // sl.step)), cnt)
    k1 = max(k0, min(max(0, -(-(hi - sl.start) // sl.step)), cnt))
    return k0, k1, slice(sl.start + sl.step * k0 - lo, sl.start + sl.step * (k1 - 1) - lo + 1, sl.step)


def _value_source(value, full_shape, full_labels, core_labels, dim_label, flips, merge: int = 0):
    """The assigned value laid out for the torch key of an assignment.

    The value broadcasts against the region's full shape (``full_labels``,
    numpy's layout, ``None`` dimensions included); the torch key writes the
    ``core_labels`` layout (no ``None`` dimensions, the dimensions of
    negative-step slices, ``flips``, reversed).  With ``dim_label`` None
    the result is that tensor; else a :class:`transport.RowSource` along
    that dimension (``merge`` > 0: the index block's ``merge`` dimensions
    merged into one).  A DNDarray value is used through its shards when it
    is, or can be resplit to be, split along that dimension; only other
    layouts are gathered."""
    full_shape = tuple(full_shape)
    nd = len(full_shape)
    target = full_labels.index(dim_label) if dim_label is not None else None

    def to_core(t, extent=None, flip_dim=True):
        shape = list(full_shape)
        if extent is not None:
            shape[target] = extent
        t = _broadcast_to(t, shape)
        for i in reversed(range(nd)):
            if full_labels[i][0] == "new":
                t = t.select(i, 0)
        rest = [lab for lab in full_labels if lab[0] != "new"]
        t = t.permute([rest.index(lab) for lab in core_labels])
        fl = [core_labels.index(lab) for lab in flips if flip_dim or lab != dim_label]
        if fl:
            t = t.flip(fl)
        if merge:
            b0 = core_labels.index(("blk", 0))
            t = t.reshape(tuple(t.shape[:b0]) + (-1,) + tuple(t.shape[b0 + merge :]))
        return t

    if isinstance(value, DNDarray):
        vd = target - (nd - value.ndim) if target is not None else -1
        if merge <= 1 and 0 <= vd < value.ndim and value.shape[vd] == full_shape[target]:
            if value.split != vd:
                value = value.resplit(vd)
            shards = [to_core(sh, sh.shape[vd], flip_dim=False) for sh in value.shards]
            return transport.RowSource(core_labels.index(dim_label), full_shape[target], shards=shards,
                                       reverse=dim_label in flips)
        value = value.larray
    t = to_core(value)
    if dim_label is None:
        return t
    dim = core_labels.index(dim_label)
    return transport.RowSource(dim, t.shape[dim], tensor=t)
