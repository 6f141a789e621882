"""Collectives over a list of shards, one tensor per mesh position
(counterpart of heat_tpu/parallel/collectives.py).

Under the single controller every position's tensor is in hand, so a
collective is a plain operation over the list.  Each returns one result per
position, as a collective inside ``shard_map`` does.

On a process comm (``comm=`` a :class:`~heat_tpu_torch.parallel.mesh.MeshComm`
built over processes) every collective takes the process route: ``parts``
are this process's parts (those of its positions, or of its live positions
for a reduction), and one result comes back per part (one when there are
none).  ``psum``, ``pmin``, ``pmax``, ``bcast`` and ``exscan`` combine the
local parts first and make one ``all_reduce`` or ``broadcast`` on the
comm's group; the minimum and maximum gather each process's combined part
(a sum of zero-filled byte rows, exact) and combine them in position order,
which keeps the complex lexicographic order and NaN propagation.

What moves shards between positions goes through :func:`exchange`, the one
primitive that carries blocks across processes: ``all_gather`` (each byte
crosses to each other process once), ``all_to_all``, ``ppermute`` and
``ring_shift`` here, and over them the transport engine, select and sort.
A pair of positions of one process moves no byte.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import telemetry

if TYPE_CHECKING:  # pragma: no cover
    from .mesh import MeshComm

__all__ = ["psum", "psum_in_order", "pmin", "pmax", "all_gather", "all_to_all", "ppermute", "ring_shift", "bcast", "exscan", "exchange"]

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


def psum_in_order(parts: Sequence[torch.Tensor], comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """:func:`psum` that adds every position's part in position order, as
    one process adds them, so the sum is the single controller's bit for
    bit: on a comm that spans processes the parts (one a position of this
    process) are gathered, each crossing to each other process once, and
    every process folds them alike.  For small parts (KMeans' counts and
    sums); elsewhere :func:`psum`."""
    if not _process(comm) or not comm.spans_processes:
        return psum(parts, comm=comm)
    rows = all_gather([p[None] for p in parts], comm=comm, lengths=[1] * comm.size)[0]
    total = rows[0]
    for r in range(1, comm.size):
        total = total + rows[r]
    return _results(total, parts)


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
    from .sort import ordered_less

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


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0, comm: Optional["MeshComm"] = None,
               lengths: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Concatenate every position's block along ``dim``, on every position.
    On a process comm ``parts`` are the blocks of this process's positions,
    in order; each block crosses to each other process once, through
    :func:`exchange`.  ``lengths``, every position's extent along ``dim``,
    spares the counts collective that reads them otherwise."""
    if _WATCHERS:
        _note("all_gather")
    if not _process(comm):
        whole = torch.cat([_to(p, parts[0]) for p in parts], dim=dim)
        return [_to(whole, p) for p in parts]
    like = parts[0]
    dim = dim % like.ndim
    local = comm.local_positions
    if lengths is None:
        counts = torch.zeros(comm.size, dtype=torch.int64, device=like.device)
        for r, p in zip(local, parts):
            counts[r] = p.shape[dim]
        lengths = _all_reduce_sum(counts, comm).tolist()  # ht: HT002 ok — the blocks' lengths size the received blocks
    mine = local[0]
    sends = {(r, comm.positions_of(q)[0]): p for r, p in zip(local, parts)
             for q in range(comm.nprocs) if q != comm.rank}
    specs = {}
    for r in range(comm.size):
        if r not in local:
            shape = list(like.shape)
            shape[dim] = int(lengths[r])  # ht: HT002 ok — host ints (the chunk rule's, or read once above)
            specs[(r, mine)] = (tuple(shape), like.dtype)
    got = exchange(sends, specs, comm, like.device)
    whole = torch.cat([parts[local.index(r)] if r in local else got[(r, mine)] for r in range(comm.size)], dim=dim)
    return [_to(whole, p) for p in parts]


def _check_perm(perm, n: int) -> None:
    seen = set()
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"ppermute: pair ({src}, {dst}) is outside {n} positions")
        if dst in seen:
            raise ValueError(f"ppermute: position {dst} receives twice")
        seen.add(dst)


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Tiled all-to-all (heat_tpu/parallel/collectives.py:124): each
    position cuts its block into N equal pieces along ``split_axis`` and
    sends piece j to position j; position i concatenates the pieces it
    receives along ``concat_axis``, in the order of their sources.  On a
    process comm ``parts`` are this process's positions' blocks, every
    block of one shape (as ``lax.all_to_all`` requires), and the pieces
    that change process travel in one :func:`exchange`."""
    if _WATCHERS:
        _note("all_to_all")
    n = comm.size if _process(comm) else len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size {p.shape[split_axis]} does not divide over {n} positions")
    pieces = [p.split(p.shape[split_axis] // n, dim=split_axis) for p in parts]
    if not _process(comm):
        return [torch.cat([_to(pieces[j][i], parts[i]) for j in range(n)], dim=concat_axis) for i in range(n)]
    local = comm.local_positions
    like = pieces[0][0]
    sends = {(r, j): pieces[k][j] for k, r in enumerate(local) for j in range(n)}
    specs = {(j, i): (tuple(like.shape), like.dtype) for i in local for j in range(n)}
    got = exchange(sends, specs, comm, like.device)
    return [torch.cat([_to(got[(j, i)], parts[k]) for j in range(n)], dim=concat_axis) for k, i in enumerate(local)]


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """General permutation over the positions (``lax.ppermute``, under
    heat_tpu/parallel/collectives.py:132): for each ``(src, dst)`` pair
    position ``dst`` receives position ``src``'s block; a position that no
    pair names receives zeros.  No position may receive twice.  On a
    process comm ``parts`` are this process's positions' blocks, every
    block of one shape, and the pairs that change process travel in one
    :func:`exchange`."""
    if _WATCHERS:
        _note("ppermute")
    perm = [(int(a), int(b)) for a, b in perm]
    if not _process(comm):
        n = len(parts)
        _check_perm(perm, n)
        out: List[Optional[torch.Tensor]] = [None] * n
        for src, dst in perm:
            out[dst] = _to(parts[src], parts[dst])
        return [torch.zeros_like(parts[j]) if o is None else o for j, o in enumerate(out)]
    _check_perm(perm, comm.size)
    local = comm.local_positions
    like = parts[0]
    sends = {(src, dst): parts[local.index(src)] for src, dst in perm if src in local}
    specs = {(src, dst): (tuple(like.shape), like.dtype) for src, dst in perm if dst in local}
    got = exchange(sends, specs, comm, like.device)
    by_dst = {dst: got[(src, dst)] for src, dst in specs}
    return [_to(by_dst[r], parts[k]) if r in by_dst else torch.zeros_like(parts[k]) for k, r in enumerate(local)]


def ring_shift(parts: Sequence[torch.Tensor], shift: int = 1, comm: Optional["MeshComm"] = None) -> List[torch.Tensor]:
    """Pass each position's block ``shift`` positions up the ring
    (heat_tpu/parallel/collectives.py:132): position (i + shift) mod N
    receives position i's block."""
    if _WATCHERS:
        _note("ring_shift")
    n = comm.size if _process(comm) else len(parts)
    return ppermute(parts, [(i, (i + shift) % n) for i in range(n)], comm=comm)


# ------------------------------------------------------------ the exchange
#: byte alignment of every block in an exchange's buffers, so that each
#: received block is a view of its dtype with no copy
_ALIGN = 16

# the exchange's counters (the port's own group; ``transport.stats()``
# shows them beside heat_tpu's transport keys)
_XSTATS = telemetry.register_group("exchange", {"exchanges": 0, "sent_bytes": 0, "staged_bytes": 0})


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _layout(items) -> Tuple[list, int]:
    """(key, offset, nbytes, shape, dtype) of each ``(key, shape, dtype)``
    in key order, every offset aligned, and the aligned total."""
    out, off = [], 0
    for key, shape, dtype in sorted(items, key=lambda e: e[0]):
        nb = dtype.itemsize
        for e in shape:
            nb *= int(e)
        out.append((key, off, nb, tuple(shape), dtype))
        off = _aligned(off + nb)
    return out, off


def _block(buf: torch.Tensor, off: int, nb: int, shape, dtype) -> torch.Tensor:
    if nb == 0:
        return torch.empty(shape, dtype=dtype, device=buf.device)
    return buf[off: off + nb].view(dtype).view(shape)


def exchange(sends: Dict[tuple, torch.Tensor], recv_specs: Dict[tuple, tuple], comm: "MeshComm",
             device=None) -> Dict[tuple, torch.Tensor]:
    """Move blocks between the positions of ``comm``: the one primitive
    that carries shards across processes.

    ``sends`` maps ``(source, destination, *tag)`` (positions, then any
    ints telling several blocks of one pair apart) to a tensor, for this
    process's sources; ``recv_specs`` maps the keys whose destination is
    this process's to the ``(shape, dtype)`` of the block, as every process
    computes them alike from global metadata (a data-dependent size comes
    from one counts collective before).  Returns the received blocks by
    key.  A pair whose two positions are this process's moves no byte: its
    block is returned as given (a view stays a view).

    On a comm that spans processes every process makes the call, also one
    that sends and receives nothing: one ``all_to_all_single`` on the
    comm's group with uneven (and zero) split sizes, each peer's blocks
    packed in key order as bytes at 16-byte offsets, so bool, complex and
    16-bit types take one route and each received block is a view of the
    receive buffer.  :meth:`MeshComm.exchange_route` picks the route from
    the backend: NCCL and CPU tensors directly, CUDA tensors on gloo
    through pinned host buffers.  ``transport.stats()`` counts the bytes
    sent to other processes (``sent_bytes``), those staged through the host
    (``staged_bytes``) and the calls (``exchanges``)."""
    if _WATCHERS:
        _note("exchange")
    local = set(comm.local_positions)
    me = comm.rank
    out: Dict[tuple, torch.Tensor] = {}
    to_peer: Dict[int, list] = {}
    from_peer: Dict[int, list] = {}
    for key in sends:
        if key[0] not in local:
            raise ValueError(f"exchange: source position {key[0]} of {key} is not this process's")
        q = comm.process_index(key[1])
        if q != me:
            t = sends[key]
            to_peer.setdefault(q, []).append((key, tuple(t.shape), t.dtype))
    for key, (shape, dtype) in recv_specs.items():
        if key[1] not in local:
            raise ValueError(f"exchange: destination position {key[1]} of {key} is not this process's")
        q = comm.process_index(key[0])
        if q == me:
            if key not in sends:
                raise ValueError(f"exchange: block {key} is expected but not sent")
            out[key] = sends[key]
        else:
            from_peer.setdefault(q, []).append((key, tuple(shape), dtype))
    if not comm.spans_processes:
        return out
    if device is None:
        device = next(iter(sends.values())).device if sends else torch.device("cpu")
    device = torch.device(device)
    n = comm.nprocs
    send_lay = [_layout(to_peer.get(q, [])) for q in range(n)]
    recv_lay = [_layout(from_peer.get(q, [])) for q in range(n)]
    in_sizes = [total for _, total in send_lay]
    out_sizes = [total for _, total in recv_lay]
    staged = comm.exchange_route(device) == "staged"
    where = torch.device("cpu") if staged else device
    send_buf = torch.empty(sum(in_sizes), dtype=torch.uint8, device=where, pin_memory=staged)
    recv_buf = torch.empty(sum(out_sizes), dtype=torch.uint8, device=where, pin_memory=staged)
    base = sent = 0
    for (items, total) in send_lay:
        for key, off, nb, shape, dtype in items:
            if nb:
                _block(send_buf, base + off, nb, shape, dtype).copy_(sends[key])
                sent += nb
        base += total
    torch.distributed.all_to_all_single(recv_buf, send_buf, out_sizes, in_sizes, group=comm.group)
    if staged:
        recv_buf = recv_buf.to(device)
    base = 0
    for (items, total) in recv_lay:
        for key, off, nb, shape, dtype in items:
            out[key] = _block(recv_buf, base + off, nb, shape, dtype)
        base += total
    _XSTATS["exchanges"] += 1
    _XSTATS["sent_bytes"] += sent
    if staged:
        _XSTATS["staged_bytes"] += sum(in_sizes) + sum(out_sizes)
    return out


def _small_device(comm: "MeshComm", device):
    """Where the agreement collectives' few integers live: the host on
    gloo, the card on NCCL."""
    return torch.device("cpu") if comm.backend == "gloo" else torch.device(device)


def agree_max(values: Sequence[int], comm: "MeshComm", device) -> List[int]:
    """Each of ``values`` (ints) maximised over the comm's processes: one
    ``all_reduce`` (the OOM back-off's failure flag and tile budget)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=_small_device(comm, device))
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=comm.group)
    return t.tolist()  # ht: HT002 ok — the agreed values steer the host's control flow


def broadcast_ints(values: Sequence[int], comm: "MeshComm", device, root: int = 0) -> List[int]:
    """``values`` (ints, as many on every process) as the comm's ``root``-th
    process holds them: one ``broadcast`` (the wire arm's agreement)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=_small_device(comm, device))
    torch.distributed.broadcast(t, src=comm.owner(comm.positions_of(root)[0]), group=comm.group)
    return t.tolist()  # ht: HT002 ok — the agreed values steer the host's control flow


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
