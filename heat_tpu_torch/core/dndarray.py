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

__all__ = ["DNDarray"]


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array.  numpy has no bfloat16 of its own:
    bfloat16 comes back as an ``ml_dtypes.bfloat16`` array of the same
    bits, and ``ml_dtypes`` is imported only here, when one is asked for."""
    t = t.detach().cpu()
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

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.size > 1

    def __repr__(self) -> str:
        return (
            f"DNDarray(shape={self.__gshape}, dtype={self.__dtype.__name__}, "
            f"split={self.__split}, device={self.__device}, comm={self.__comm})"
        )

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
        return self

    def item(self):
        if self.size != 1:
            raise ValueError("only one-element arrays can be converted to Python scalars")
        return self.larray.reshape(()).item()

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

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
