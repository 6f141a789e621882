"""Collectives over a list of shards, one tensor per mesh position
(counterpart of heat_tpu/parallel/collectives.py).

Under the single controller every position's tensor is in hand, so a
collective is a plain operation over the list.  Each returns one result per
position, as a collective inside ``shard_map`` does.

On a process comm (``comm=`` a :class:`~heat_tpu_torch.parallel.mesh.MeshComm`
built over processes) ``psum``, ``pmin``, ``pmax``, ``all_gather``,
``bcast`` and ``exscan`` take the process route: ``parts`` are this
process's parts (those of its positions, or of its live positions for a
reduction), combined locally first, then one ``torch.distributed`` call
runs on the comm's group, and one result comes back per part (one when
there are none).  The route needs only ``all_reduce`` and ``broadcast``,
the two calls gloo takes on CUDA tensors: a gather is a sum of zero-filled
byte buffers, each process writing its own bytes, so it is exact; the
minimum and maximum gather each process's combined part and combine them
in position order, which keeps the complex lexicographic order and NaN
propagation.  ``all_to_all``, ``ppermute`` and ``ring_shift`` move shards
between positions and refuse a comm that spans processes (ROADMAP item
14b).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import torch

from .sort import ordered_less

if TYPE_CHECKING:  # pragma: no cover
    from .mesh import MeshComm

__all__ = ["psum", "pmin", "pmax", "all_gather", "all_to_all", "ppermute", "ring_shift", "bcast", "exscan"]

# callables told the name of each collective as it runs (the program
# auditor's watch, analysis/program_audit.py); empty in the steady state
_WATCHERS: list = []


def _note(op: str) -> None:
    for w in _WATCHERS:
        w(op)


def _to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


def _process(comm) -> bool:
    return comm is not None and comm.is_process_comm


def _all_reduce_sum(t: torch.Tensor, comm: "MeshComm") -> torch.Tensor:
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.SUM, group=comm.group)
    return t


def _gather_bytes(mine: Optional[torch.Tensor], like: torch.Tensor, comm: "MeshComm") -> List[Optional[torch.Tensor]]:
    """Every process's tensor of ``like``'s shape and dtype, or None where a
    process gave none: one ``all_reduce`` of zero-filled byte rows, each
    process writing its bytes and a presence byte into its own row."""
    n, me = comm.nprocs, comm.rank
    nbytes = like.numel() * like.element_size()
    buf = torch.zeros((n, nbytes + 1), dtype=torch.uint8, device=like.device)
    if mine is not None:
        flat = mine.detach().to(like.dtype).contiguous().reshape(-1)
        if nbytes:
            buf[me, :nbytes] = flat.view(torch.uint8) if flat.dtype != torch.bool else flat.to(torch.uint8)
        buf[me, nbytes] = 1
    _all_reduce_sum(buf, comm)
    present = buf[:, nbytes].tolist()  # ht: HT002 ok — which processes gave a tensor decides the result's parts
    out = []
    for p in range(n):
        if not present[p]:
            out.append(None)
            continue
        row = buf[p, :nbytes].clone()  # its own storage, aligned for the view
        val = row.to(torch.bool) if like.dtype == torch.bool else row.view(like.dtype)
        out.append(val.reshape(like.shape))
    return out


def _results(value: torch.Tensor, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [_to(value, p) for p in parts] if len(parts) else [value]


def psum(parts: Sequence[torch.Tensor], comm: Optional["MeshComm"] = None, like=None) -> List[torch.Tensor]:
    """All-reduce sum: every position receives the sum of all parts.  On a
    process comm, ``like`` (a tensor of the result's shape and dtype) stands
    in when this process has no part."""
    if _WATCHERS:
        _note("psum")
    if not _process(comm):
        total = parts[0]
        for p in parts[1:]:
            total = total + _to(p, total)
        return [_to(total, p) for p in parts]
    if len(parts):
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + _to(p, total)
    else:
        total = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
    return _results(_all_reduce_sum(total.contiguous(), comm), parts)


def psum_flat(tensors: Sequence[torch.Tensor], comm: "MeshComm") -> None:
    """Sum ``tensors`` in place over ``comm`` by :func:`psum`, as one
    flattened buffer a dtype (one buffer in the usual all-f32 case): the
    gradient all-reduce of data-parallel training and DASO's sync."""
    by_type = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for group in by_type.values():
        flat = psum([torch.cat([t.reshape(-1) for t in group])], comm=comm)[0]
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _extreme(parts, comm, like, lower: bool, name: str) -> List[torch.Tensor]:
    def pick(a, b):
        b = _to(b, a)
        if a.is_complex():
            return torch.where(ordered_less(b, a) if lower else ordered_less(a, b), b, a)
        return torch.minimum(a, b) if lower else torch.maximum(a, b)

    if _WATCHERS:
        _note(name)
    mine = None
    for p in parts:
        mine = p if mine is None else pick(mine, p)
    if not _process(comm):
        return [_to(mine, p) for p in parts]
    template = mine if mine is not None else torch.empty(like.shape, dtype=like.dtype, device=like.device)
    best = None
    for v in _gather_bytes(mine, template, comm):
        if v is not None:
            best = v if best is None else pick(best, v)
    return _results(best, parts)


def pmin(parts: Sequence[torch.Tensor], comm: Optional["MeshComm"] = None, like=None) -> List[torch.Tensor]:
    """All-reduce elementwise minimum (complex values in NumPy's
    lexicographic order; a NaN wins)."""
    return _extreme(parts, comm, like, True, "pmin")


def pmax(parts: Sequence[torch.Tensor], comm: Optional["MeshComm"] = None, like=None) -> List[torch.Tensor]:
    """All-reduce elementwise maximum (complex values in NumPy's
    lexicographic order; a NaN wins)."""
    return _extreme(parts, comm, like, False, "pmax")


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0, comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Concatenate every position's block along ``dim``, on every position.
    On a process comm ``parts`` are the blocks of this process's positions,
    in order."""
    if _WATCHERS:
        _note("all_gather")
    if not _process(comm):
        whole = torch.cat([_to(p, parts[0]) for p in parts], dim=dim)
        return [_to(whole, p) for p in parts]
    like = parts[0]
    dim = dim % like.ndim
    lengths = torch.zeros(comm.size, dtype=torch.int64, device=like.device)
    for r, p in zip(comm.local_positions, parts):
        lengths[r] = p.shape[dim]
    lengths = _all_reduce_sum(lengths, comm).tolist()  # ht: HT002 ok — the blocks' lengths size the gathered buffer
    shape = list(like.shape)
    shape[dim] = sum(lengths)
    whole = torch.zeros(shape, dtype=like.dtype, device=like.device)
    for r, p in zip(comm.local_positions, parts):
        whole.narrow(dim, sum(lengths[:r]), lengths[r]).copy_(_to(p, whole))
    raw = whole.view(torch.uint8) if like.dtype != torch.bool else whole.to(torch.uint8)
    raw = _all_reduce_sum(raw.contiguous(), comm)
    whole = raw.to(torch.bool) if like.dtype == torch.bool else raw.view(like.dtype)
    return [_to(whole, p) for p in parts]


def _refuse_across(name: str, comm) -> None:
    if comm is not None:
        comm.only_local(f"collectives.{name}")


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Tiled all-to-all (heat_tpu/parallel/collectives.py:124): each
    position cuts its block into N equal pieces along ``split_axis`` and
    sends piece j to position j; position i concatenates the pieces it
    receives along ``concat_axis``, in the order of their sources."""
    if _WATCHERS:
        _note("all_to_all")
    _refuse_across("all_to_all", comm)
    n = len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size {p.shape[split_axis]} does not divide over {n} positions")
    pieces = [p.split(p.shape[split_axis] // n, dim=split_axis) for p in parts]
    return [torch.cat([_to(pieces[j][i], parts[i]) for j in range(n)], dim=concat_axis) for i in range(n)]


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """General permutation over the positions (``lax.ppermute``, under
    heat_tpu/parallel/collectives.py:132): for each ``(src, dst)`` pair
    position ``dst`` receives position ``src``'s block; a position that no
    pair names receives zeros.  No position may receive twice."""
    if _WATCHERS:
        _note("ppermute")
    _refuse_across("ppermute", comm)
    n = len(parts)
    out: List[Optional[torch.Tensor]] = [None] * n
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"ppermute: pair ({src}, {dst}) is outside {n} positions")
        if out[dst] is not None:
            raise ValueError(f"ppermute: position {dst} receives twice")
        out[dst] = _to(parts[src], parts[dst])
    return [torch.zeros_like(parts[j]) if o is None else o for j, o in enumerate(out)]


def ring_shift(parts: Sequence[torch.Tensor], shift: int = 1, comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Pass each position's block ``shift`` positions up the ring
    (heat_tpu/parallel/collectives.py:132): position (i + shift) mod N
    receives position i's block."""
    if _WATCHERS:
        _note("ring_shift")
    _refuse_across("ring_shift", comm)
    n = len(parts)
    return ppermute(parts, [(i, (i + shift) % n) for i in range(n)])


def exscan(parts: Sequence[torch.Tensor], comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Exclusive prefix sum over the positions
    (heat_tpu/parallel/collectives.py:155): position r receives the sum of
    the blocks of positions 0 .. r-1, position 0 zeros.  On a process comm
    ``parts`` are this process's positions' blocks, in order."""
    if _WATCHERS:
        _note("exscan")
    run = torch.zeros_like(parts[0])
    if _process(comm):
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + _to(p, total)
        for v in _gather_bytes(total, total, comm)[: comm.rank]:
            run = run + v
    out = []
    for p in parts:
        out.append(_to(run, p))
        run = run + _to(p, run)
    return out


def bcast(parts: Sequence[torch.Tensor], root: int = 0, comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Every position receives the ``root`` position's tensor.  On a
    process comm every process gives its parts (of the root's shape and
    dtype), and the root's owner sends."""
    if _WATCHERS:
        _note("bcast")
    if not _process(comm):
        return [_to(parts[root], p) for p in parts]
    owner = comm.owner(root)
    if root in comm.local_positions:
        buf = parts[comm.local_positions.index(root)].clone().contiguous()
    else:
        buf = torch.empty_like(parts[0]).contiguous()
    torch.distributed.broadcast(buf, src=owner, group=comm.group)
    return _results(buf, parts)
