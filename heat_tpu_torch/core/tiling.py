"""Tile decompositions of a DNDarray (counterpart of heat_tpu/core/tiling.py).

``SplitTiles`` is the decomposition by position: along the split axis each
position's chunk is one tile, every other dimension whole.
``SquareDiagTiles`` cuts each position's chunk along the split axis into
``tiles_per_proc`` tiles and anchors the other axis's borders to the main
diagonal, the geometry of the reference's tiled QR.  Both carry the JAX
package's metadata (tile maps, owners, start and stop indices).  Reading a
tile returns the owning shard's view of it (the pieces of several shards
joined, for a slice of tiles across positions); writing one goes through
``DNDarray.__setitem__``, each position writing its part in place.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dndarray import DNDarray
from ..parallel import transport

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _read(arr: DNDarray, rs: slice, cs: slice) -> torch.Tensor:
    """``arr[rs, cs]`` of a 2-D array (unit steps) from the shards that
    hold it: a view when one shard does."""
    if arr.split is None:
        return arr.shards[0][rs, cs]
    key = [rs, cs]
    lo, hi = key[arr.split].start, key[arr.split].stop
    pieces = []
    for r, s in enumerate(arr.shards):
        off = arr.comm.chunk(arr.shape, arr.split, rank=r)[0]
        a, b = max(lo, off), min(hi, off + s.shape[arr.split])
        if a < b:
            local = list(key)
            local[arr.split] = slice(a - off, b - off)
            pieces.append(s[tuple(local)])
    if not pieces:
        shape = [rs.stop - rs.start, cs.stop - cs.start]
        return arr.shards[0].new_empty(shape)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=arr.split)


class SplitTiles:
    """One tile per position along the split axis (heat_tpu/core/tiling.py:22)."""

    def __init__(self, arr: DNDarray):
        self.__arr = arr
        comm = arr.comm
        borders = []
        for dim in range(arr.ndim):
            if dim == arr.split:
                edges = [0]
                for r in range(comm.size):
                    off, lshape, _ = comm.chunk(arr.shape, arr.split, rank=r)
                    edges.append(off + lshape[arr.split])
                borders.append(np.asarray(edges))
            else:
                borders.append(np.asarray([0, arr.shape[dim]]))
        self.__borders = borders

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_dimensions(self) -> list:
        """Tile sizes along each dimension."""
        return [np.diff(b) for b in self.__borders]

    @property
    def tile_locations(self) -> np.ndarray:
        """The position owning each tile along the split axis."""
        if self.__arr.split is None:
            return np.zeros(1, dtype=np.int64)
        return np.arange(self.__arr.comm.size, dtype=np.int64)

    def tile_ranges(self, rank: int) -> Tuple[slice, ...]:
        """Global index slices of position ``rank``'s tile."""
        arr = self.__arr
        return arr.comm.chunk(arr.shape, arr.split, rank=rank)[2]

    def __getitem__(self, key) -> torch.Tensor:
        """Position ``key``'s tile: its shard (a view).  Any other rank reads
        what the JAX package's chunk slice selects: nothing for a rank past
        the mesh, and Python's negative-bound slicing for a negative rank
        (rank −1 nothing; rank −4 of 7 rows at 4 positions, slice(−8, −6),
        row 0).  A slice key raises ``TypeError``."""
        if isinstance(key, slice):
            raise TypeError("tiles are read by rank, not by slice")
        rank = key if isinstance(key, int) else key[0]
        arr = self.__arr
        if arr.split is None:
            return arr.shards[0]
        if 0 <= rank < arr.comm.size:
            return arr.shards[rank]
        n = arr.shape[arr.split]
        rows = range(n)[self.tile_ranges(rank)[arr.split]]
        return transport.RowSource(arr.split, n, shards=arr.shards).range(rows.start, rows.stop)


class SquareDiagTiles:
    """Diagonal-anchored 2-D tile grid (heat_tpu/core/tiling.py:75)."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if arr.ndim != 2:
            raise ValueError(f"arr must be 2-D, got {arr.ndim}-D")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        if arr.split not in (0, 1):
            raise ValueError("arr must be split along axis 0 or 1")
        self.__arr = arr
        self.__tiles_per_proc = tiles_per_proc
        m, n = arr.shape
        comm = arr.comm
        # each position's chunk cut into tiles_per_proc near-equal tiles
        split_edges, owners = [0], []
        for r in range(comm.size):
            off, lshape, _ = comm.chunk(arr.shape, arr.split, rank=r)
            base, rem = divmod(lshape[arr.split], tiles_per_proc)
            pos = off
            for t in range(tiles_per_proc):
                sz = base + (1 if t < rem else 0)
                if sz == 0:
                    continue
                pos += sz
                split_edges.append(pos)
                owners.append(r)
        # the other axis: the split edges clipped to the diagonal, then one
        # trailing tile for what lies beyond it
        diag = min(m, n)
        perp_len = n if arr.split == 0 else m
        perp_edges = sorted({min(x, diag) for x in split_edges} | {perp_len})
        row_edges, col_edges = (split_edges, perp_edges) if arr.split == 0 else (perp_edges, split_edges)
        self.__set_grid([int(x) for x in row_edges], [int(x) for x in col_edges], owners)

    def __set_grid(self, row_edges: List[int], col_edges: List[int], owners: List[int]) -> None:
        arr = self.__arr
        self.__row_edges, self.__col_edges = row_edges, col_edges
        self.__row_inds, self.__col_inds = row_edges[:-1], col_edges[:-1]
        self.__owners = owners
        nrows, ncols = len(self.__row_inds), len(self.__col_inds)
        tmap = np.zeros((nrows, ncols, 3), dtype=np.int64)
        for i in range(nrows):
            for j in range(ncols):
                tmap[i, j, 0] = row_edges[i + 1] - row_edges[i]
                tmap[i, j, 1] = col_edges[j + 1] - col_edges[j]
                tmap[i, j, 2] = owners[i if arr.split == 0 else j]
        self.__tile_map = tmap
        # the last position holding a tile of the diagonal
        split_edges = row_edges if arr.split == 0 else col_edges
        diag = min(arr.shape)
        ldp = 0
        for k, edge in enumerate(split_edges[:-1]):
            if edge < diag:
                ldp = owners[k]
        self.__last_diag_pr = ldp

    # ------------------------------------------------------------ properties
    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tiles_per_proc(self) -> int:
        return self.__tiles_per_proc

    @property
    def row_indices(self) -> list:
        """Global first row of each tile row."""
        return list(self.__row_inds)

    @property
    def col_indices(self) -> list:
        """Global first column of each tile column."""
        return list(self.__col_inds)

    @property
    def tile_rows(self) -> int:
        return len(self.__row_inds)

    @property
    def tile_columns(self) -> int:
        return len(self.__col_inds)

    @property
    def tile_map(self) -> np.ndarray:
        """(rows, columns, 3): each tile's height, width and owner."""
        return self.__tile_map

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.lshape_map

    @property
    def last_diagonal_process(self) -> int:
        return self.__last_diag_pr

    @property
    def tile_rows_per_process(self) -> list:
        if self.__arr.split == 0:
            counts = [0] * self.__arr.comm.size
            for r in self.__owners:
                counts[r] += 1
            return counts
        return [self.tile_rows] * self.__arr.comm.size

    @property
    def tile_columns_per_process(self) -> list:
        if self.__arr.split == 1:
            counts = [0] * self.__arr.comm.size
            for r in self.__owners:
                counts[r] += 1
            return counts
        return [self.tile_columns] * self.__arr.comm.size

    # ---------------------------------------------------------------- access
    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """(row start, row stop, column start, column stop) of tile
        ``key = (i, j)`` in global indices."""
        i, j = key
        if i < 0:
            i += self.tile_rows
        if j < 0:
            j += self.tile_columns
        return self.__row_edges[i], self.__row_edges[i + 1], self.__col_edges[j], self.__col_edges[j + 1]

    @staticmethod
    def __slice(edges, k, ntiles) -> slice:
        if isinstance(k, slice):
            start, stop, step = k.indices(ntiles)
            if step != 1:
                raise ValueError("tile slices must be contiguous")
            return slice(edges[start], edges[stop])
        if k < 0:
            k += ntiles
        return slice(edges[k], edges[k + 1])

    def __slices(self, key):
        if isinstance(key, int):
            key = (key, slice(None))
        i, j = key
        return (self.__slice(self.__row_edges, i, self.tile_rows),
                self.__slice(self.__col_edges, j, self.tile_columns))

    def __getitem__(self, key) -> torch.Tensor:
        """The data of tile ``key`` (an int, or a pair of ints or unit-step
        slices of tiles) from the shards that hold it."""
        return _read(self.__arr, *self.__slices(key))

    def __setitem__(self, key, value) -> None:
        self.__arr[self.__slices(key)] = value

    def local_get(self, key):
        """Tile data by the calling position's own tile index (position 0
        under the single controller)."""
        return self[self.__local_to_global(key)]

    def local_set(self, key, value) -> None:
        self[self.__local_to_global(key)] = value

    def __local_to_global(self, key):
        if isinstance(key, int):
            key = (key, slice(None))
        i, j = key
        first = next((k for k, r in enumerate(self.__owners) if r == self.__arr.comm.rank), 0)
        if self.__arr.split == 0 and isinstance(i, int) and i >= 0:
            i += first
        elif self.__arr.split == 1 and isinstance(j, int) and j >= 0:
            j += first
        return (i, j)

    def match_tiles(self, other: "SquareDiagTiles") -> None:
        """Take ``other``'s borders where this array's shape allows
        (heat_tpu/core/tiling.py:215); split-axis tiles belong to the
        position whose chunk holds their first index."""
        arr = self.__arr
        m, n = arr.shape
        row_edges = sorted({min(e, m) for e in other.__row_edges} | {0, m})
        col_edges = sorted({min(e, n) for e in other.__col_edges} | {0, n})
        split_edges = row_edges if arr.split == 0 else col_edges
        chunk_ends = []
        for r in range(arr.comm.size):
            off, lshape, _ = arr.comm.chunk(arr.shape, arr.split, rank=r)
            chunk_ends.append(off + lshape[arr.split])
        owners = [next(r for r, e in enumerate(chunk_ends) if start < e) for start in split_edges[:-1]]
        self.__set_grid(row_edges, col_edges, owners)
