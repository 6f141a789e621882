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

import contextlib
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import telemetry

if TYPE_CHECKING:  # pragma: no cover
    from .mesh import MeshComm

__all__ = ["psum", "psum_in_order", "pmin", "pmax", "all_gather", "all_to_all", "ppermute", "ring_shift", "bcast", "exscan",
           "exchange", "grad_chain", "cut", "join"]

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
             comm: Optional["MeshComm"] = None, shape_of: Optional[Callable[[int], tuple]] = None) -> List[torch.Tensor]:
    """General permutation over the positions (``lax.ppermute``, under
    heat_tpu/parallel/collectives.py:132): for each ``(src, dst)`` pair
    position ``dst`` receives position ``src``'s block; a position that no
    pair names receives zeros (of its own block's shape).  No position may
    receive twice.  On a process comm ``parts`` are this process's
    positions' blocks, of one shape unless ``shape_of(position)`` gives
    each position's, and the pairs that change process travel in one
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
    specs = {(src, dst): (tuple(like.shape) if shape_of is None else tuple(shape_of(src)), like.dtype)
             for src, dst in perm if dst in local}
    got = exchange(sends, specs, comm, like.device)
    by_dst = {dst: got[(src, dst)] for src, dst in specs}
    return [_to(by_dst[r], parts[k]) if r in by_dst else torch.zeros_like(parts[k]) for k, r in enumerate(local)]


def ring_shift(parts: Sequence[torch.Tensor], shift: int = 1, comm: Optional["MeshComm"] = None,
               shape_of: Optional[Callable[[int], tuple]] = None) -> List[torch.Tensor]:
    """Pass each position's block ``shift`` positions up the ring
    (heat_tpu/parallel/collectives.py:132): position (i + shift) mod N
    receives position i's block (``shape_of`` as in :func:`ppermute`)."""
    if _WATCHERS:
        _note("ring_shift")
    n = comm.size if _process(comm) else len(parts)
    return ppermute(parts, [(i, (i + shift) % n) for i in range(n)], comm=comm, shape_of=shape_of)


def ring_shift_start(parts: Sequence[torch.Tensor], shift: int = 1, comm: Optional["MeshComm"] = None,
                     shape_of: Optional[Callable[[int], tuple]] = None) -> Callable[[], List[torch.Tensor]]:
    """:func:`ring_shift` on a comm that spans processes, issued without
    waiting (no autograd): the returned call waits and gives the blocks.
    The overlap rings issue a hop before their step's GEMM with it."""
    if _WATCHERS:
        _note("ring_shift")
    n = comm.size
    local = comm.local_positions
    like = parts[0]
    perm = [(i, (i + shift) % n) for i in range(n)]
    keep, sends, specs = {}, {}, {}
    for src, dst in perm:
        if src in local and dst in local:
            keep[dst] = parts[local.index(src)]
        elif src in local:
            sends[(src, dst)] = parts[local.index(src)]
        elif dst in local:
            specs[(src, dst)] = (tuple(like.shape) if shape_of is None else tuple(shape_of(src)), like.dtype)
    pending = _move_start(sends, specs, comm, like.device, True)

    def finish() -> List[torch.Tensor]:
        got = {dst: t for (src, dst), t in pending().items()}
        got.update(keep)
        return [got[r] for r in local]

    return finish


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
    (``staged_bytes``) and the calls (``exchanges``).

    Autograd crosses the exchange where gradients are recorded and a sent
    block requires them, or inside :func:`grad_chain`: the backward is the
    transposed exchange (each block's gradient goes back from its
    destination to its source through the same route), a block with no
    gradient sending zeros of its shape, so every process enters it."""
    if _WATCHERS:
        _note("exchange")
    local = set(comm.local_positions)
    me = comm.rank
    out: Dict[tuple, torch.Tensor] = {}
    cross: Dict[tuple, torch.Tensor] = {}
    specs: Dict[tuple, tuple] = {}
    for key in sends:
        if key[0] not in local:
            raise ValueError(f"exchange: source position {key[0]} of {key} is not this process's")
        if comm.process_index(key[1]) != me:
            cross[key] = sends[key]
    for key, spec in recv_specs.items():
        if key[1] not in local:
            raise ValueError(f"exchange: destination position {key[1]} of {key} is not this process's")
        if comm.process_index(key[0]) == me:
            if key not in sends:
                raise ValueError(f"exchange: block {key} is expected but not sent")
            out[key] = sends[key]
        else:
            specs[key] = (tuple(spec[0]), spec[1])
    if not comm.spans_processes:
        return out
    if device is None:
        device = next(iter(sends.values())).device if sends else torch.device("cpu")
    device = torch.device(device)
    if _records_grad(cross.values()):
        keys = tuple(cross)
        got = _ExchangeFn.apply((keys, specs, comm, device), _anchor(device), *(cross[k] for k in keys))
        _advance(got[0])
        out.update(zip(specs, got[1:]))
    else:
        out.update(_move(cross, specs, comm, device))
    return out


def _records_grad(tensors) -> bool:
    """Whether a move of ``tensors`` across processes must carry autograd."""
    return torch.is_grad_enabled() and (bool(_CHAIN) or any(t.requires_grad for t in tensors))


def _move(sends: Dict[tuple, torch.Tensor], specs: Dict[tuple, tuple], comm: "MeshComm", device) -> Dict[tuple, torch.Tensor]:
    """The bytes of :func:`exchange` between processes: ``sends`` and
    ``specs`` hold only pairs whose positions belong to different
    processes; one ``all_to_all_single`` carries them."""
    return _move_start(sends, specs, comm, device, False)()


def _move_start(sends: Dict[tuple, torch.Tensor], specs: Dict[tuple, tuple], comm: "MeshComm", device,
                async_op: bool) -> Callable[[], Dict[tuple, torch.Tensor]]:
    """:func:`_move` issued (``async_op``: ``all_to_all_single`` with
    ``async_op=True``); the returned call waits for it and unpacks the
    received blocks."""
    n = comm.nprocs
    to_peer: Dict[int, list] = {}
    from_peer: Dict[int, list] = {}
    for key, t in sends.items():
        to_peer.setdefault(comm.process_index(key[1]), []).append((key, tuple(t.shape), t.dtype))
    for key, (shape, dtype) in specs.items():
        from_peer.setdefault(comm.process_index(key[0]), []).append((key, tuple(shape), dtype))
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
    work = torch.distributed.all_to_all_single(recv_buf, send_buf, out_sizes, in_sizes, group=comm.group,
                                               async_op=async_op)
    _XSTATS["exchanges"] += 1
    _XSTATS["sent_bytes"] += sent
    if staged:
        _XSTATS["staged_bytes"] += sum(in_sizes) + sum(out_sizes)

    def finish() -> Dict[tuple, torch.Tensor]:
        buf = recv_buf
        if work is not None:
            work.wait()
        if staged:
            buf = buf.to(device)
        out: Dict[tuple, torch.Tensor] = {}
        base = 0
        for (items, total) in recv_lay:
            for key, off, nb, shape, dtype in items:
                out[key] = _block(buf, base + off, nb, shape, dtype)
            base += total
        return out

    return finish


def _swap(key: tuple) -> tuple:
    return (key[1], key[0]) + tuple(key[2:])


def _differentiable(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


class _ExchangeFn(torch.autograd.Function):
    """The blocks between processes with a gradient: forward one
    :func:`_move`, backward the transposed one.  The first input and
    output are the :func:`grad_chain` anchor."""

    @staticmethod
    def forward(ctx, plan, anchor, *tensors):
        keys, specs, comm, device = plan
        got = _move(dict(zip(keys, tensors)), specs, comm, device)
        ctx.plan = plan
        ctx.sent = [(tuple(t.shape), t.dtype) for t in tensors]
        # own storage: the outputs are not views of one receive buffer
        return (anchor.new_zeros(()),) + tuple(got[k].clone() for k in specs)

    @staticmethod
    def backward(ctx, g_anchor, *grads):
        keys, specs, comm, device = ctx.plan
        back = {}
        for key, g in zip(specs, grads):
            shape, dtype = specs[key]
            back[_swap(key)] = g if g is not None and _differentiable(dtype) else torch.zeros(shape, dtype=dtype,
                                                                                               device=device)
        got = _move(back, {_swap(k): s for k, s in zip(keys, ctx.sent)}, comm, device)
        return (None, g_anchor) + tuple(got[_swap(k)] if _differentiable(s[1]) else None
                                        for k, s in zip(keys, ctx.sent))


# ----------------------------------------------- replicated <-> positions
# the open grad chains (innermost last): each a one-item list holding the
# anchor that the chain's next collective takes and replaces
_CHAIN: List[list] = []


@contextlib.contextmanager
def grad_chain(active: bool = True):
    """Order the backward of the collectives across processes.  Inside the
    block every :func:`exchange`, :func:`cut` and :func:`join` takes the
    chain's anchor (a scalar) as an extra input and hands a new one on, and
    :func:`join` ends the chain: autograd then runs their backwards (each a
    collective every process must enter) in the reverse order of their
    forwards on every process, also a collective whose outputs reach the
    loss on no process.  The entry points that take replicated tensors
    (sequence, expert and pipeline parallelism) open one per call; a no-op
    where gradients are not recorded or ``active`` is false."""
    if not active or not torch.is_grad_enabled():
        yield
        return
    _CHAIN.append([None])
    try:
        yield
    finally:
        _CHAIN.pop()


def _anchor(device) -> torch.Tensor:
    """The innermost chain's anchor (a new leaf at its first use), or a
    scalar outside any chain."""
    if not _CHAIN:
        return torch.zeros((), device=device)
    cell = _CHAIN[-1]
    if cell[0] is None:
        cell[0] = torch.zeros((), device=device, requires_grad=True)
    return cell[0]


def _advance(anchor: torch.Tensor) -> None:
    if _CHAIN:
        _CHAIN[-1][0] = anchor


def _block_shape(shape, index) -> Tuple[int, ...]:
    return tuple(torch.empty(shape, device="meta")[index].shape)


def _assemble(mine: Dict[int, torch.Tensor], blocks: Dict[int, tuple], shape, dtype, comm: "MeshComm",
              device) -> torch.Tensor:
    """The whole tensor of ``shape`` from every position's block
    (``blocks`` maps each position to its index tuple): this process's
    blocks ``mine`` cross to each other process once, and every process
    writes every block into its place (copies only, so the result is the
    same bits everywhere)."""
    got = {}
    if comm.spans_processes:
        firsts = [comm.positions_of(q)[0] for q in range(comm.nprocs)]
        me0 = firsts[comm.rank]
        sends = {(r, firsts[q]): t for r, t in mine.items() for q in range(comm.nprocs) if q != comm.rank}
        specs = {(r, me0): (_block_shape(shape, blocks[r]), dtype) for r in range(comm.size) if r not in mine}
        got = {k[0]: v for k, v in _move(sends, specs, comm, device).items()}
    full = torch.zeros(shape, dtype=dtype, device=device)
    for r in range(comm.size):
        full[blocks[r]] = mine[r] if r in mine else got[r]
    return full


class _CutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, anchor, x):
        comm, blocks = plan
        ctx.plan, ctx.meta = plan, (tuple(x.shape), x.dtype, x.device)
        return (anchor.new_zeros(()),) + tuple(x[blocks[r]].clone() for r in comm.local_positions)

    @staticmethod
    def backward(ctx, g_anchor, *grads):
        comm, blocks = ctx.plan
        shape, dtype, device = ctx.meta
        mine = {r: (g if g is not None else torch.zeros(_block_shape(shape, blocks[r]), dtype=dtype, device=device))
                for r, g in zip(comm.local_positions, grads)}
        return None, g_anchor, _assemble(mine, blocks, shape, dtype, comm, device)


class _JoinFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, anchor, *parts):
        comm, blocks, shape = plan
        ctx.plan = plan
        like = parts[0]
        return _assemble(dict(zip(comm.local_positions, parts)), blocks, shape, like.dtype, comm, like.device)

    @staticmethod
    def backward(ctx, g):
        comm, blocks, _ = ctx.plan
        return (None, torch.zeros((), device=g.device)) + tuple(g[blocks[r]] for r in comm.local_positions)


def cut(x: torch.Tensor, blocks: Dict[int, tuple], comm: "MeshComm") -> List[torch.Tensor]:
    """The blocks of a tensor that every process holds alike (replicated)
    for this process's positions: ``x[blocks[r]]`` for each of
    ``comm.local_positions``.  Its backward all-gathers every position's
    gradient block, so every process holds the whole gradient of ``x``
    (the blocks are disjoint; nothing is summed)."""
    local = comm.local_positions
    if comm.spans_processes and torch.is_grad_enabled() and x.requires_grad:
        got = _CutFn.apply((comm, blocks), _anchor(x.device), x)
        _advance(got[0])
        return list(got[1:])
    return [x[blocks[r]] for r in local]


def join(parts: Sequence[torch.Tensor], blocks: Dict[int, tuple], shape, comm: "MeshComm") -> torch.Tensor:
    """The whole tensor of ``shape``, on every process alike, from the
    blocks of this process's positions (``parts``, in
    ``comm.local_positions`` order) and the other processes'.  Its backward
    keeps this process's positions' slices of the incoming gradient and
    sums nothing: every process computes the same loss from the joined
    tensor.  Inside a :func:`grad_chain` it ends the chain."""
    parts = list(parts)
    like = parts[0]
    if not comm.spans_processes:
        if len(parts) == 1 and comm.size == 1:
            return parts[0]
        full = like.new_zeros(shape)
        for r, p in zip(comm.local_positions, parts):
            full[blocks[r]] = p
        return full
    if torch.is_grad_enabled() and (_CHAIN or any(p.requires_grad for p in parts)):
        out = _JoinFn.apply((comm, blocks, tuple(shape)), _anchor(like.device), *parts)
        if _CHAIN:
            _CHAIN[-1][0] = None
        return out
    return _assemble(dict(zip(comm.local_positions, parts)), blocks, tuple(shape), like.dtype, comm, like.device)


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
