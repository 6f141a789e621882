"""The transport engine over the shard list: resplit, split-crossing
reshape and row take (counterpart of heat_tpu/parallel/transport.py).

Every layout change of a split array is a data-movement program whose
destination shards are known on the host from the chunk rule alone.  The
JAX package runs each as a loop of bounded tiles of one collective; under
the port's single controller every position's shard is in hand, so each
destination shard is assembled directly from the pieces of the source
shards that cover it, and the result never passes through the gathered
array:

``tiled_resplit``
    split ``sa`` → split ``sb`` (the all-to-all of ``_build_tiled_resplit``):
    destination shard d is the concatenation along ``sa`` of every source
    shard's ``narrow`` view of d's chunk of ``sb``.  The caller drops the
    old shards afterwards (``DNDarray.resplit_``), the port's form of
    donation.
``tiled_reshape``
    a reshape whose split dimension and everything before it keep their
    extent reshapes each shard as a view; any other one runs resplit to
    split 0, a flat *rechunk*, and resplit to the target split.  The
    rechunk follows :func:`rechunk_plan`: each (source, destination) overlap
    is one contiguous interval, so destination d is covered exactly by at
    most 1 + ``_MAX_SHIFTS`` intervals, one per ring shift, and one launch
    of the repack kernel (K7, :mod:`heat_tpu_torch.ops.repack`) writes it in
    its final shape.  A destination with no rows launches nothing.
``tiled_take``
    ``out[t] = in[rows[t]]`` along the split axis, per destination chunk
    of the output: each source shard contributes the requested rows it
    owns (the ``psum_scatter`` of ``_build_tiled_gather``, in plain torch).
``rechunk_rows``, ``RowSource``
    the assignment side (``DNDarray.__setitem__``): a split value's rows
    re-cut at explicit destination bounds, where a key meets each
    position, by K7 (``rechunk_rows``, into a shard's row range or a
    piece-sized buffer); and the value rows a position receives, by range
    or by index, each from the value shard that holds it (``RowSource``,
    the reverse of ``tiled_take``).

Each of the four runs as heat_tpu's transport kernels do: inside a
``transport.<kind>`` span, after the ``guard.fire`` injection hook and
before ``guard.corrupt``, as a program of the ledger (timed by
``telemetry.timed_call`` when sampled; a split-crossing reshape carries
K7's bytes, the other moves no work count), with its output shards
ledgered as ``output`` (:mod:`~heat_tpu_torch.core.memtrack`).  The
``transport`` counter group keeps heat_tpu's keys.

Wire formats (:mod:`~heat_tpu_torch.core.wire`): a resplit and a
split-crossing reshape of a floating payload of ``HEAT_TPU_WIRE_MIN_BYTES``
or more consult the wire arms (``wire.eligible``/``choose``/``explore``/
``account``), as heat_tpu's engine does.  A quantized resplit encodes each
row of each column tile of each (source, destination) block with one scale
(heat_tpu's ``(pa, S)`` rows of a tile, :506-526) and decodes it on
landing; a quantized rechunk encodes each chunk of each shifted segment with
one scalar scale (:1128-1137) and K7 writes the destination from the
decoded segments; the unshifted segments stay exact.  The values of a lossy
wire depend on where the blocks are cut, so the grain is heat_tpu's:
:func:`tile_plan` over ``TILE_BYTES`` (``HEAT_TPU_TILE_BYTES``, 8 MiB) for
a resplit's column tiles, ``TILE_BYTES`` over the item size for a rechunk's
chunk, a pure function of shape and budget (nothing is staged).  A device
that reports its memory may shrink the budget from its free bytes
(``memtrack.suggest_budget``), as in heat_tpu.  ``exact=True`` pins the
f32 wire.  A take never quantizes (``wire.decline("take")``).  On a CUDA
tensor with the tuning plane on, the rechunk keeps K7's one-arm row under
heat_tpu's ``reshape_repack`` key (``autotune.kernel_site``).

The fused split tail (:func:`_lower_split_tail`, heat_tpu :718-1034): a
pending lazy chain whose every op is a registered shape-preserving map, and
whose leaves are full-shape arrays in the source split or one-element
scalars, is evaluated straight into a resplit, one band of columns of one
source shard at a time (the band lands in each destination it crosses),
from views of the source shards; the chain is never
materialized whole in the old split, and stays pending for its other
consumers.  The port's shards hold no pad rows or columns, so the chain
never runs on a pad lane and nothing needs zeroing.  A chain whose resplit
would take a quantized wire declines, so the materialize-then-resplit
route applies the wire as it would without fusion.

The OOM back-off (:func:`_with_oom_backoff`, heat_tpu :200): every
transfer runs at a tile budget, and an out-of-memory error
(``torch.OutOfMemoryError``, which :class:`~heat_tpu_torch.utils.fault.InjectedOOM`
subclasses) halves it and runs the same route again, down to
``TILE_FLOOR_BYTES``, where it re-raises.  The first retry is sized from
the measured free memory where the device reports it.  The budget sets a
lossy wire's cut and a fused tail's band; the exact routes stage nothing
(each destination is written in place), so their retry runs the same
launches, K7's included.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..analysis import program_audit, sanitize
from ..core import autotune, guard, memtrack, telemetry
from ..core import wire as _wire
from ..ops import repack as _repack

__all__ = [
    "TILE_BYTES",
    "TILE_FLOOR_BYTES",
    "RowSource",
    "rechunk_plan",
    "rechunk_rows",
    "reset_stats",
    "reshape_applicable",
    "resplit_applicable",
    "stats",
    "tiled_reshape",
    "tiled_resplit",
    "tiled_take",
    "tile_plan",
]

# Beyond this many distinct ring shifts the rechunk degenerates toward a
# latency-bound permute chain; callers fall back to the gathered route
# (heat_tpu/parallel/transport.py:298).
_MAX_SHIFTS = 4

# bytes of rows a take gathers at a time into a destination shard
_TAKE_BYTES = 64 << 20

# the staging budget of a tile (heat_tpu/parallel/transport.py:93-110):
# it sets where a lossy wire cuts its blocks
TILE_BYTES = autotune.env_bytes("HEAT_TPU_TILE_BYTES", 8 << 20)
# the smallest budget a memory-seeded plan may give
TILE_FLOOR_BYTES = 64 << 10
# the fraction of measured free memory a seeded tile may claim
_FREE_TILE_FRACTION = 0.25


def tile_plan(n_units, unit_bytes, tile_bytes=None) -> Tuple[int, int]:
    """Cut ``n_units`` units of ``unit_bytes`` each into even tiles within
    the budget (heat_tpu/parallel/transport.py:301): ``(units_per_tile,
    n_tiles)`` with ``units_per_tile * n_tiles >= n_units``."""
    tb = TILE_BYTES if tile_bytes is None else int(tile_bytes)
    n_units = max(int(n_units), 1)
    per = max(1, tb // max(int(unit_bytes), 1))
    if per >= n_units:
        return n_units, 1
    n_tiles = -(-n_units // per)
    return -(-n_units // n_tiles), n_tiles


def _plan_tile_budget(kind: str, tile_bytes=None) -> int:
    """The tile budget of one transfer (heat_tpu :181): the caller's, else
    with the tuning plane on a budget seeded from the measured free memory
    where the device reports it, else ``TILE_BYTES``."""
    if tile_bytes is not None:
        return int(tile_bytes)
    if not autotune.enabled():
        return TILE_BYTES
    got = memtrack.suggest_budget(TILE_BYTES, fraction=_FREE_TILE_FRACTION, floor=TILE_FLOOR_BYTES)
    if got is None or got >= TILE_BYTES:
        return TILE_BYTES
    autotune.note_budget_seed("transport." + kind, got, TILE_BYTES)
    return got


def _bounds(n: int, S: int) -> List[Tuple[int, int]]:
    """(start, stop) of each position's chunk of an extent ``n``: even
    ``ceil(n/S)`` chunks, the trailing ones truncated (MeshComm.chunk)."""
    per = -(-n // S) if n > 0 else 0
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(S)]


def _prefix_prod(shape: Sequence[int], k: int) -> int:
    return math.prod(int(e) for e in shape[:k])


def _ranges(bounds, m: int, rowsz: int) -> List[Tuple[int, int]]:
    """Explicit per-destination (start, stop) rows as element ranges, each
    inside [0, m)."""
    if any(not 0 <= int(lo) <= int(hi) <= m for lo, hi in bounds):
        raise ValueError(f"destination bounds {list(bounds)} do not lie in [0, {m})")
    return [(int(lo) * rowsz, int(hi) * rowsz) for lo, hi in bounds]


def rechunk_plan(m_in, rowsz_in, m_out, rowsz_out, S, dst_bounds=None, max_shifts=_MAX_SHIFTS):
    """Host plan for moving the flat element stream from split-0 rows of
    size ``rowsz_in`` to split-0 rows of size ``rowsz_out``
    (heat_tpu/parallel/transport.py:1036; equal results).

    Both chunk boundary sets are host-known, so each (source, destination)
    overlap is one contiguous interval; entries are grouped by ring shift
    ``(d - r) % S`` and, per shift, hold tuples indexed by SOURCE shard of
    (local source offset, destination-local offset, length).  Returns a
    hashable tuple of ``(shift, src_off, dst_off, lens)`` entries, or
    ``None`` when the plan needs more than ``max_shifts`` distinct nonzero
    shifts (no limit for ``None``), or the sizes disagree or are 0.
    ``dst_bounds``, one (start, stop) of output rows per destination, each
    inside [0, m_out), replaces the chunk rule on the destination side: the
    rows where an assignment's key meets each position (a destination may
    also take rows another one takes, or none)."""
    M = m_in * rowsz_in
    if M != m_out * rowsz_out or M == 0:
        return None
    pa = -(-m_in // S)
    B_in = [min(r * pa, m_in) * rowsz_in for r in range(S + 1)]
    if dst_bounds is None:
        pb = -(-m_out // S)
        R_out = [(min(d * pb, m_out) * rowsz_out, min((d + 1) * pb, m_out) * rowsz_out) for d in range(S)]
    else:
        R_out = _ranges(dst_bounds, m_out, rowsz_out)
    shifts = {}
    for r in range(S):
        lo_r, hi_r = B_in[r], B_in[r + 1]
        if lo_r == hi_r:
            continue
        for d, (lo_d, hi_d) in enumerate(R_out):
            lo = max(lo_r, lo_d)
            hi = min(hi_r, hi_d)
            if lo >= hi:
                continue
            s = (d - r) % S
            ent = shifts.setdefault(s, {"src": [0] * S, "dst": [0] * S, "len": [0] * S})
            ent["src"][r] = lo - B_in[r]
            ent["dst"][r] = lo - lo_d
            ent["len"][r] = hi - lo
    if max_shifts is not None and sum(1 for s in shifts if s != 0) > max_shifts:
        return None
    return tuple(
        (s, tuple(e["src"]), tuple(e["dst"]), tuple(e["len"])) for s, e in sorted(shifts.items())
    )


def resplit_applicable(gshape: Sequence[int], sa, sb, comm) -> bool:
    """True iff :func:`tiled_resplit` handles this layout change: a real
    axis-to-axis move over several positions with every extent nonzero
    (heat_tpu/parallel/transport.py:560)."""
    return (
        comm.size > 1
        and sa is not None
        and sb is not None
        and sa != sb
        and len(gshape) >= 2
        and all(int(d) > 0 for d in gshape)
    )


def reshape_applicable(gin, si, gout, so, comm) -> bool:
    """True iff :func:`tiled_reshape` handles this reshape: split input and
    output over several positions, every extent nonzero, and a rechunk plan
    within the shift budget (heat_tpu/parallel/transport.py:1204)."""
    if comm.size <= 1 or si is None or so is None:
        return False
    if any(int(d) <= 0 for d in gin) or any(int(d) <= 0 for d in gout):
        return False
    if _prefix_prod(gin, si) == _prefix_prod(gout, so) and int(gin[si]) == int(gout[so]):
        return True  # split-preserving: the per-shard path
    rowsz_in = _prefix_prod(gin, len(gin)) // int(gin[0])
    rowsz_out = _prefix_prod(gout, len(gout)) // int(gout[0])
    return rechunk_plan(int(gin[0]), rowsz_in, int(gout[0]), rowsz_out, comm.size) is not None


# heat_tpu's "transport" counter group: the OOM back-off's counters and
# ``fused_tails``, the fused split tails
_STATS = telemetry.register_group(
    "transport",
    {
        "oom_retries": 0,
        "oom_exhausted": 0,
        "last_tile_bytes": None,
        "retries_by_kind": {},
        "informed_retries": 0,
        "last_retry_informed": None,
        "fused_tails": 0,
    },
)


def _is_oom(err: BaseException) -> bool:
    """An allocation failure: the caching allocator's
    ``torch.OutOfMemoryError`` (an injected one subclasses it)."""
    return isinstance(err, torch.OutOfMemoryError)


def _with_oom_backoff(kind: str, run, tile_bytes=None, fp=None, device=None, observer=None):
    """``run(tile_bytes)`` with heat_tpu's bounded OOM back-off (:200): on an
    out-of-memory error the budget halves and the same route runs again,
    down to ``TILE_FLOOR_BYTES``, where the error is re-raised; any other
    error propagates untouched.  ``guard.fire`` gives an installed injector
    each attempt.  The first retry is sized from the measured free memory
    (a quarter of it, never more than the halving) where the device
    reports it (the card, or ``FaultInjector.low_hbm``).  Every OOM leaves
    a buffer census on the flight recorder, and the first one a postmortem;
    the counters are heat_tpu's.  A run is timed into ``fp``'s ledger row
    when sampled."""
    tb = _plan_tile_budget(kind, tile_bytes)
    retried = False
    while True:
        try:
            guard.fire(f"transport.{kind}")
            out = telemetry.timed_call(fp, run, tb, device=device, observer=observer)
        except Exception as err:  # noqa: BLE001 — filtered to OOM below
            if not _is_oom(err):
                raise
            census = memtrack.census(top=8) if telemetry.events_enabled() else None
            if tb <= TILE_FLOOR_BYTES:
                _STATS["oom_exhausted"] += 1
                telemetry.record_event("oom_exhausted", kernel=kind, tile_bytes=tb, census=census)
                telemetry.postmortem("transport_oom_exhausted", kernel=kind, tile_bytes=tb)
                raise
            halved = max(TILE_FLOOR_BYTES, tb >> 1)
            informed = free = None
            if not retried:
                free = memtrack.min_free_bytes()
                if free is not None:
                    informed = memtrack.suggest_budget(halved, fraction=_FREE_TILE_FRACTION,
                                                       floor=TILE_FLOOR_BYTES, free=free)
                telemetry.postmortem("transport_oom", kernel=kind, tile_bytes=tb)
            tb = informed if informed is not None else halved
            retried = True
            _STATS["oom_retries"] += 1
            if informed is not None:
                _STATS["informed_retries"] += 1
            _STATS["last_retry_informed"] = informed is not None
            by_kind = _STATS["retries_by_kind"]
            by_kind[kind] = by_kind.get(kind, 0) + 1
            telemetry.record_event("oom_retry", kernel=kind, tile_bytes=tb, informed=informed is not None,
                                   free_bytes=free, census=census)
            continue
        _STATS["last_tile_bytes"] = tb
        return out


def _engine(kind: str, key: tuple, like: torch.Tensor, comm, split, run, *, tile_bytes=None, kernel_bytes=None,
            wire=None, observer=None, chain=True):
    """Run ``run(tile_bytes)`` as the transport program ``kind`` under the
    OOM back-off: ledgered under ``key`` (with K7's bytes where
    ``kernel_bytes`` is given, else no work count; a quantized wire
    ``(mode, logical_bytes, wire_bytes)`` makes it heat_tpu's
    ``<kind>_wire`` row), in a span, between the guard's hooks, its output
    shards ledgered.  ``observer`` sees its sampled times.  ``chain``
    appends the dispatch to the sanitizer's collective chain (a reshape
    appends its stages itself, in heat_tpu's order)."""
    fp = None
    if telemetry.ledger_enabled():
        extra = {}
        name = (kind,) + key + (comm.size, str(like.dtype))
        if wire is not None:
            name += (wire[0],)
            extra = {"wire": wire[0], "logical_bytes": float(wire[1]), "wire_bytes": float(wire[2])}
        fp = telemetry.fingerprint(name)
        if kernel_bytes is None:
            telemetry.ensure_program(fp, kind=f"transport_{kind}", ops=1, mesh={"devices": comm.size},
                                     dtype=str(like.dtype), **extra)
        else:
            telemetry.ensure_program(fp, kind="kernel_repack", ops=1, flops=0.0, hbm_bytes=float(kernel_bytes),
                                     mesh={"devices": comm.size}, dtype=str(like.dtype), **extra)
    with telemetry.span(f"transport.{kind}"):
        if program_audit.enabled():
            run = program_audit.watched(f"transport_{kind}", fp, run, expect="any")
        out = _with_oom_backoff(kind, run, tile_bytes, fp=fp, device=like.device, observer=observer)
    if chain:
        _link(kind)
    memtrack.register_shards([o for o in out if o is not None], tag="output", split=split)
    return guard.corrupt(f"transport.{kind}", out)


def _link(kind: str) -> None:
    """One link of the sanitizer's collective chain for a dispatch that
    moves data between positions (heat_tpu :293): the lockstep fingerprint
    every rank must share."""
    sanitize.collective_event(kind, site=f"transport.{kind}")


def _wired(site: str, geometry: tuple, desc: str, dtype, logical_bytes: int, wire_bytes, exact: bool, run):
    """One transfer under its wire decision (heat_tpu :668-706,
    :1356-1394): ``run(mode, observer)`` with ``mode`` in ``""`` (f32),
    ``"int8"``, ``"fp8"``.  An explore runs all three and returns the f32
    result; a quantized arm is accounted, and a table-decided one feeds the
    degradation watch through ``observer``.  ``wire_bytes(mode)`` is the
    format's on-wire byte count."""
    arm, d = "wire_f32", None
    if logical_bytes and _wire.eligible(dtype, logical_bytes, exact=exact):
        arm, d = _wire.choose(site, geometry, desc=desc)
    if d is not None and d.explore:
        return _wire.explore(d, lambda wm: run(wm, None))
    if arm == "wire_f32":
        return run("", None)
    wm = arm[len("wire_"):]
    _wire.account(site, arm, logical_bytes, wire_bytes(wm))
    observer = None if d is None else (lambda dur: autotune.observe(d.key, arm, dur))
    return run(wm, observer)


def _resplit_wire_model(gshape, sa: int, sb: int, S: int, itemsize: int, tile_bytes=None):
    """(logical bytes, scales) of a resplit's quantized wire (heat_tpu
    :630-635): every element once, one scale a (row, destination, tile)
    on each position."""
    pa = -(-int(gshape[sa]) // S)
    pb = -(-int(gshape[sb]) // S)
    rest = math.prod(int(e) for d, e in enumerate(gshape) if d not in (sa, sb))
    _, n_tiles = tile_plan(pb, pa * S * rest * itemsize, tile_bytes)
    return math.prod(int(e) for e in gshape) * itemsize, pa * S * n_tiles * S


def _resplit_stage(shards, gshape, sa: int, sb: int, comm, exact: bool, tile_bytes, run):
    """A resplit's wire decision: ``run(mode, observer)`` as in
    :func:`_wired`, under heat_tpu's ``resplit`` geometry."""
    gshape_t = tuple(int(d) for d in gshape)
    S = comm.size
    dt = shards[0].dtype
    logical, n_scales = _resplit_wire_model(gshape_t, sa, sb, S, shards[0].element_size(), tile_bytes)
    nelem = math.prod(gshape_t)
    return _wired("resplit", (gshape_t, int(sa), int(sb), S, autotune.dtype_name(dt)),
                  f"resplit {gshape_t} {sa}->{sb} {autotune.dtype_name(dt)} S={S}", dt, logical,
                  lambda wm: _wire.payload_nbytes(nelem, n_scales, wm), exact, run)


def tiled_resplit(shards: Sequence[torch.Tensor], gshape: Sequence[int], sa: int, sb: int, comm, *,
                  exact: bool = False, tile_bytes=None) -> List[torch.Tensor]:
    """The shards of a ``gshape`` array split along ``sa``, moved to split
    ``sb`` (heat_tpu/parallel/transport.py:574): destination shard d joins,
    along ``sa``, each source shard's view of d's chunk of ``sb``.  The
    result's shards are new contiguous tensors; the sources are untouched.
    A floating payload may travel on a quantized wire (module docstring);
    ``exact=True`` pins the f32 wire."""
    if len(shards) != comm.size:
        raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
    sanitize.check_use(list(shards), "transport.tiled_resplit")
    key = (tuple(int(d) for d in gshape), int(sa), int(sb))

    def run(wm, observer):
        wire = None
        if wm:
            logical, n_scales = _resplit_wire_model(gshape, sa, sb, comm.size, shards[0].element_size(), tile_bytes)
            wire = (wm, logical, _wire.payload_nbytes(math.prod(key[0]), n_scales, wm))
        return _engine("resplit", key, shards[0], comm, sb, lambda tb: _resplit(shards, gshape, sa, sb, comm, wm, tb),
                       tile_bytes=tile_bytes, wire=wire, observer=observer)

    return _resplit_stage(shards, gshape, sa, sb, comm, exact, tile_bytes, run)


def _resplit(shards: Sequence[torch.Tensor], gshape: Sequence[int], sa: int, sb: int, comm, wm: str = "",
             tile_bytes=None) -> List[torch.Tensor]:
    """The shards of a ``gshape`` array split along ``sa``, moved to split
    ``sb``: destination shard d joins, along ``sa``, each source shard's
    view of d's chunk of ``sb``, through the wire ``wm`` (``""`` exact)."""
    bounds = _bounds(int(gshape[sb]), comm.size)
    if not wm:
        return [torch.cat([s.narrow(sb, lo, hi - lo) for s in shards], dim=sa) for lo, hi in bounds]
    S = comm.size
    pa = -(-int(gshape[sa]) // S)
    pb = -(-int(gshape[sb]) // S)
    rest = math.prod(int(e) for d, e in enumerate(gshape) if d not in (sa, sb))
    tile_cols, n_tiles = tile_plan(pb, pa * S * rest * shards[0].element_size(), _plan_tile_budget("resplit", tile_bytes))
    return [torch.cat([_wire_block(s.narrow(sb, lo, hi - lo), sa, sb, tile_cols, n_tiles, wm) for s in shards], dim=sa)
            for lo, hi in bounds]


def _wire_block(blk: torch.Tensor, sa: int, sb: int, tile_cols: int, n_tiles: int, wm: str) -> torch.Tensor:
    """One (source, destination) block of a resplit through the quantized
    wire (heat_tpu :506-526): each row along ``sa`` of each tile of
    ``tile_cols`` columns along ``sb`` (counted from the destination's
    first column) is encoded with one scale over the tile's columns and
    every other axis, then decoded.  The zero columns that pad the last
    tile change no absmax and are cut off again."""
    if blk.numel() == 0:
        return blk.clone()
    v = blk.movedim((sa, sb), (0, 1))
    rows, cols = v.shape[0], v.shape[1]
    rest = tuple(v.shape[2:])
    padded = n_tiles * tile_cols
    if padded != cols:
        v = torch.cat([v, v.new_zeros((rows, padded - cols) + rest)], dim=1)
    v = v.reshape((rows, n_tiles, tile_cols) + rest)
    q, scale = _wire.absmax_encode(v, wm, (0, 1))
    out = _wire.absmax_decode(q, scale, (0, 1), blk.dtype).reshape((rows, padded) + rest)[:, :cols]
    return out.movedim((0, 1), (sa, sb))


def _wire_segment(src: torch.Tensor, off: int, length: int, ch: int, wm: str) -> torch.Tensor:
    """One shifted segment of a rechunk through the quantized wire (heat_tpu
    :1128-1137): cut into chunks of ``ch`` elements from its start, each
    encoded with one scalar scale over the whole chunk (past the segment's
    end the chunk reads the source's next elements, and zeros past the
    source's end), then decoded; the segment's ``length`` elements."""
    n_ch = -(-length // ch)
    blk = src[off : off + n_ch * ch]
    if blk.numel() < n_ch * ch:
        blk = torch.cat([blk, blk.new_zeros(n_ch * ch - blk.numel())])
    q, scale = _wire.absmax_encode(blk.reshape(n_ch, ch), wm, (0,))
    return _wire.absmax_decode(q, scale, (0,), src.dtype).reshape(-1)[:length]


def _rechunk_wire_model(plan, S: int, itemsize: int):
    """(elements, scales) a quantized rechunk ships (heat_tpu :1324-1338):
    per nonzero shift, each position sends its chunks, the last one whole,
    one scale a chunk."""
    chunk = max(1, TILE_BYTES // itemsize)
    elems = scales = 0
    for s, _, _, lens in plan:
        if s % S == 0:
            continue
        ch = min(chunk, max(lens))
        n_ch = -(-max(lens) // ch)
        elems += S * n_ch * ch
        scales += S * n_ch
    return elems, scales


def _rechunk(flat: Sequence[torch.Tensor], plan, gout: Tuple[int, ...], comm, dst_bounds=None, out=None, wm: str = "",
             chunk: int = 0) -> List:
    """Split-0 shards of ``gout`` from the flat split-0 source shards
    ``flat`` following ``plan``: one K7 call per destination with rows, or
    one per :data:`~heat_tpu_torch.ops.repack.MAX_SEGMENTS` segments where
    more source chunks cover it.  ``dst_bounds`` as in :func:`rechunk_plan`;
    ``out``, one contiguous tensor (or ``None``) per destination, is
    written in place of a new one.  A destination without rows gets an
    empty tensor, or ``None`` when ``out`` is given.  With a wire mode
    ``wm``, every shifted segment arrives through :func:`_wire_segment` in
    chunks of ``min(chunk, the shift's longest segment)`` elements."""
    S = comm.size
    res = []
    bounds = _bounds(gout[0], S) if dst_bounds is None else dst_bounds
    for d, (lo, hi) in enumerate(bounds):
        shape = (hi - lo,) + tuple(gout[1:])
        if hi == lo:
            res.append(flat[0].new_empty(shape) if out is None else None)
            continue
        segs = []
        for s, src_off, dst_off, lens in plan:
            r = (d - s) % S
            if lens[r]:
                if wm and s % S != 0:
                    seg = _wire_segment(flat[r], src_off[r], lens[r], min(chunk, max(lens)), wm)
                    segs.append((dst_off[r], r, seg, 0, lens[r]))
                else:
                    segs.append((dst_off[r], r, flat[r], src_off[r], lens[r]))
        segs.sort(key=lambda e: (e[0], e[1]))
        at = 0
        for dst, *_, length in segs:
            if dst != at:
                raise AssertionError(f"rechunk plan leaves a gap or overlap at element {at} of destination {d}")
            at += length
        if at != math.prod(shape):
            raise AssertionError(f"rechunk plan covers {at} of destination {d}'s {math.prod(shape)} elements")
        dest = out[d] if out is not None and out[d] is not None else None
        if len(segs) <= _repack.MAX_SEGMENTS:
            res.append(_repack.repack_segments([(t, so, ln) for _, _, t, so, ln in segs], shape, out=dest))
            continue
        if dest is None:
            dest = flat[0].new_empty(shape)
        whole = dest.view(-1)
        for i in range(0, len(segs), _repack.MAX_SEGMENTS):
            group = segs[i : i + _repack.MAX_SEGMENTS]
            n = sum(length for *_, length in group)
            _repack.repack_segments([(t, so, ln) for _, _, t, so, ln in group], (n,), out=whole.narrow(0, group[0][0], n))
        res.append(dest)
    return res


def rechunk_rows(shards: Sequence[torch.Tensor], dst_bounds, comm, out=None) -> List:
    """The rows of a split-0 array (``shards`` in the chunk rule, each
    contiguous) re-cut at explicit destination bounds: for each position,
    its (start, stop) of the array's rows.  Each destination with rows is
    written by K7 from the source chunks that cover it, into ``out[d]`` (a
    contiguous tensor of those rows' shape, such as a shard's row range)
    or into a new tensor; destinations without rows give ``None``.  Bit
    for bit; no other copy of the array exists."""
    m = sum(int(s.shape[0]) for s in shards)
    nbytes = m * math.prod(shards[0].shape[1:]) * shards[0].element_size()
    key = (m, tuple(shards[0].shape[1:]), tuple(dst_bounds))
    return _engine("rechunk", key, shards[0], comm, 0, lambda tb: _rechunk_rows(shards, dst_bounds, comm, out),
                   kernel_bytes=2 * nbytes)


def _rechunk_rows(shards: Sequence[torch.Tensor], dst_bounds, comm, out=None) -> List:
    m = sum(int(s.shape[0]) for s in shards)
    tail = tuple(shards[0].shape[1:])
    rowsz = math.prod(tail)
    if m == 0 or rowsz == 0:
        return [None] * comm.size
    plan = rechunk_plan(m, rowsz, m, rowsz, comm.size, dst_bounds=dst_bounds, max_shifts=None)
    flat = [s.view(-1) for s in shards]
    return _rechunk(flat, plan, (m,) + tail, comm, dst_bounds=dst_bounds, out=out if out is not None else [None] * comm.size)


def tiled_reshape(
    shards: Sequence[torch.Tensor], gin: Sequence[int], si: int, gout: Sequence[int], so: int, comm, *,
    exact: bool = False, tile_bytes=None,
) -> List[torch.Tensor]:
    """The shards of the reshape of a ``gin`` array split along ``si`` to
    ``gout`` split along ``so`` (heat_tpu/parallel/transport.py:1224).
    Callers check :func:`reshape_applicable` first.  Each stage of a
    split-crossing reshape (resplit to split 0, rechunk, resplit to ``so``)
    takes its own wire decision; ``exact=True`` pins the f32 wire on every
    stage."""
    gin = tuple(int(d) for d in gin)
    gout = tuple(int(d) for d in gout)
    sanitize.check_use(list(shards), "transport.tiled_reshape")
    crossing = not (_prefix_prod(gin, si) == _prefix_prod(gout, so) and gin[si] == gout[so])
    nbytes = math.prod(gin) * shards[0].element_size()
    return _engine("reshape", (gin, int(si), gout, int(so)), shards[0], comm, so,
                   lambda tb: _reshape(shards, gin, si, gout, so, comm, exact, tb), tile_bytes=tile_bytes,
                   kernel_bytes=2 * nbytes if crossing else None, chain=False)


def _resplit_inner(shards, gshape, sa: int, sb: int, comm, exact: bool, tile_bytes):
    """A resplit stage inside a reshape, under its own wire decision; a
    quantized arm is timed as heat_tpu's ``resplit_wire`` row."""
    gshape_t = tuple(int(d) for d in gshape)

    def run(wm, observer):
        _link("resplit")
        if not wm:
            return _resplit(shards, gshape_t, sa, sb, comm)
        fp = _wire_row("resplit", (gshape_t, int(sa), int(sb)), shards[0], comm, wm,
                       *_resplit_wire_model(gshape_t, sa, sb, comm.size, shards[0].element_size(), tile_bytes))
        return telemetry.timed_call(fp, _resplit, shards, gshape_t, sa, sb, comm, wm, tile_bytes, observer=observer,
                                    device=shards[0].device)

    return _resplit_stage(shards, gshape_t, sa, sb, comm, exact, tile_bytes, run)


def _wire_row(kind: str, key: tuple, like: torch.Tensor, comm, wm: str, logical: int, n_scales: int,
              n_elems: Optional[int] = None):
    """heat_tpu's ``<kind>_wire`` ledger row of one quantized stage, with
    its logical and on-wire bytes (the Prometheus wire gauges read them)."""
    if not telemetry.ledger_enabled():
        return None
    if n_elems is None:
        n_elems = logical // like.element_size()
    fp = telemetry.fingerprint((kind + "_wire",) + key + (comm.size, str(like.dtype), wm))
    telemetry.ensure_program(fp, kind=f"transport_{kind}", ops=1, mesh={"devices": comm.size},
                             dtype=str(like.dtype), wire=wm, logical_bytes=float(logical),
                             wire_bytes=float(_wire.payload_nbytes(n_elems, n_scales, wm)))
    return fp


def _reshape(shards: Sequence[torch.Tensor], gin, si: int, gout, so: int, comm, exact: bool = False,
             tile_bytes=None) -> List[torch.Tensor]:
    S = comm.size
    if _prefix_prod(gin, si) == _prefix_prod(gout, so) and gin[si] == gout[so]:
        # split-preserving: chunk boundaries never crossed, each position
        # reshapes its own block
        out = []
        for s in shards:
            local = list(gout)
            local[so] = s.shape[si]
            out.append(s.reshape(local))
        return out
    if si != 0:
        shards = _resplit_inner(shards, gin, si, 0, comm, exact, tile_bytes)
    rowsz_in = _prefix_prod(gin, len(gin)) // gin[0]
    rowsz_out = _prefix_prod(gout, len(gout)) // gout[0]
    plan = rechunk_plan(gin[0], rowsz_in, gout[0], rowsz_out, S)
    if plan is None:
        raise ValueError(f"no rechunk plan within {_MAX_SHIFTS} shifts for {gin} -> {gout} over {S} positions")
    # the kernel reads contiguous flat sources: a strided split-0 shard
    # (a view a caller built) is copied here, explicitly
    flat = [s.contiguous().view(-1) for s in shards]
    del shards
    like = flat[0]
    itemsize = like.element_size()
    chunk = max(1, _plan_tile_budget("reshape", tile_bytes) // itemsize)
    elems, scales = _rechunk_wire_model(plan, S, itemsize)
    dt = autotune.dtype_name(like.dtype)

    def run(wm, observer):
        _link("reshape")
        if wm:
            fp = _wire_row("reshape", (gin, int(si), gout, int(so)), like, comm, wm, elems * itemsize, scales, elems)
            return telemetry.timed_call(fp, _rechunk, flat, plan, gout, comm, None, None, wm, chunk,
                                        observer=observer, device=like.device)
        if autotune.site_tunes(like):
            # K7's one-arm row under heat_tpu's key (transport.py:1396-1434)
            key = autotune.kernel_key("reshape_repack", gin, int(si), gout, int(so), S, dt)
            fp_k = None
            if telemetry.ledger_enabled():
                fp_k = telemetry.fingerprint(("reshape_repack", gin, int(si), gout, int(so), S, dt))
                telemetry.ensure_program(fp_k, kind="kernel_repack", ops=1, flops=0.0,
                                         hbm_bytes=2.0 * math.prod(gin) * itemsize, mesh={"devices": S}, dtype=dt)
            return autotune.kernel_site(key, f"reshape {gin}->{gout} minor={gout[-1]}", _rechunk, flat, plan, gout,
                                        comm, fp=fp_k, device=like.device)
        return _rechunk(flat, plan, gout, comm)

    out = _wired("rechunk", (gin, gout, S, dt), f"rechunk {gin}->{gout} {dt} S={S}", like.dtype, elems * itemsize,
                 lambda wm: _wire.payload_nbytes(elems, scales, wm), exact, run)
    del flat
    if so != 0:
        out = _resplit_inner(out, gout, 0, so, comm, exact, tile_bytes)
    return out


def tiled_take(
    shards: Sequence[torch.Tensor], rows: torch.Tensor, n: int, split: int, comm
) -> List[torch.Tensor]:
    """``out[t] = in[rows[t]]`` along ``split`` of an array whose extent
    there is ``n``, as the output's shards (heat_tpu/parallel/transport.py:395).
    ``rows`` is a 1-D integer tensor already normalised to ``[0, n)``; the
    output's extent along ``split`` is ``len(rows)``, cut by the chunk rule.
    Each requested row has one owner, the position whose chunk holds it;
    a destination chunk gathers from each owner only the rows it owns and
    copies them into place, so every output row moves once, at most
    ``_TAKE_BYTES`` of them at a time beside the output.  The host reads
    one (destination, owner) table of row counts per call."""
    _wire.decline("take")
    key = (tuple(shards[0].shape), int(rows.numel()), int(n), int(split))
    return _engine("take", key, shards[0], comm, split, lambda tb: _take(shards, rows, n, split, comm))


def _take(shards: Sequence[torch.Tensor], rows: torch.Tensor, n: int, split: int, comm) -> List[torch.Tensor]:
    S = comm.size
    src_b = _bounds(int(n), S)
    dst_b = _bounds(int(rows.numel()), S)
    dev = shards[0].device
    rows = rows.to(device=dev, dtype=torch.int64)
    # the first position whose chunk ends past a row owns it (empty chunks
    # end where their predecessor does, so they own nothing)
    owner = torch.searchsorted(torch.tensor([hi for _, hi in src_b], dtype=torch.int64, device=dev), rows, right=True)
    per = max(dst_b[0][1], 1)
    dest = torch.arange(rows.numel(), device=dev) // per
    # rows a gather moves at a time: what is in flight beside the output
    # stays under _TAKE_BYTES
    row_bytes = shards[0].element_size() * max(1, math.prod(e for i, e in enumerate(shards[0].shape) if i != split))
    batch = max(1, _TAKE_BYTES // row_bytes)
    counts = torch.bincount(dest * S + owner, minlength=S * S).view(S, S).tolist()
    out = []
    for d, (lo, hi) in enumerate(dst_b):
        idx = rows[lo:hi]
        sole = [r for r in range(S) if hi > lo and counts[d][r] == hi - lo]
        if sole:
            r = sole[0]
            out.append(shards[r].index_select(split, idx - src_b[r][0]))
            continue
        shape = list(shards[0].shape)
        shape[split] = hi - lo
        block = shards[0].new_empty(shape)
        order = torch.argsort(owner[lo:hi], stable=True)
        at = 0
        for r, c in enumerate(counts[d]):
            for b in range(at, at + c, batch):
                pos = order[b : min(b + batch, at + c)]
                block.index_copy_(split, pos, shards[r].index_select(split, idx[pos] - src_b[r][0]))
            at += c
        out.append(block)
    return out


class RowSource:
    """A value to assign, laid along dimension ``dim`` of the region it
    fills, whose extent there is ``n``: a tensor already broadcast to the
    region (``tensor``), or the shards of a split array cut along ``dim``
    by the chunk rule (``shards``).  ``reverse`` reads the rows backwards
    (the region's rows ascend where the key's slice steps down).

    A destination position takes the rows it receives with :meth:`range`
    (a mask's or a slice's contiguous run) or :meth:`take` (the rows of an
    integer key it owns, the reverse of :func:`tiled_take`).  From shards,
    each value row is read from the shard that holds it, once; the value
    is never gathered."""

    def __init__(self, dim: int, n: int, tensor: torch.Tensor = None, shards: Sequence[torch.Tensor] = None,
                 reverse: bool = False):
        self.dim, self.n, self.tensor, self.reverse = dim, int(n), tensor, reverse
        self.shards = None if shards is None else list(shards)
        self.bounds = None if shards is None else _bounds(self.n, len(self.shards))

    def range(self, a: int, b: int) -> torch.Tensor:
        """Region rows [a, b) along :attr:`dim`."""
        if self.reverse:
            return self._range(self.n - b, self.n - a).flip(self.dim)
        return self._range(a, b)

    def _range(self, a: int, b: int) -> torch.Tensor:
        if self.tensor is not None:
            return self.tensor.narrow(self.dim, a, b - a)
        parts = [s.narrow(self.dim, max(a, lo) - lo, min(b, hi) - max(a, lo))
                 for s, (lo, hi) in zip(self.shards, self.bounds) if max(a, lo) < min(b, hi)]
        if not parts:
            return self.shards[0].narrow(self.dim, 0, 0)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.dim)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Region rows ``idx`` (a 1-D int64 tensor) along :attr:`dim`, in
        that order."""
        if self.reverse:
            idx = self.n - 1 - idx
        if self.tensor is not None:
            return self.tensor.index_select(self.dim, idx.to(self.tensor.device))
        dev = self.shards[0].device
        idx = idx.to(dev)
        owner = torch.searchsorted(torch.tensor([hi for _, hi in self.bounds], dtype=torch.int64, device=dev), idx, right=True)
        shape = list(self.shards[0].shape)
        shape[self.dim] = int(idx.numel())
        out = self.shards[0].new_empty(shape)
        for q, (s, (lo, _)) in enumerate(zip(self.shards, self.bounds)):
            pos = torch.nonzero(owner == q).reshape(-1)
            if pos.numel():
                out.index_copy_(self.dim, pos, s.index_select(self.dim, idx[pos] - lo))
        return out


# ------------------------------------------------- fused elementwise tail

# Op kinds a tile can replay: shape-preserving maps whose value at an
# element depends on that element alone (heat_tpu :715).
_FUSED_TAIL_KINDS = frozenset({"elementwise", "cast", "comparison", "predicate"})


def _tail_op_ok(fn, kw) -> bool:
    from ..core import fusion

    for k, v in kw or ():
        if k == "op":
            meta = fusion._OP_TABLE.get(v)
            return meta is not None and meta[1] in _FUSED_TAIL_KINDS
    meta = fusion._OP_TABLE.get(fn)
    return meta is not None and meta[1] in _FUSED_TAIL_KINDS


def _lower_split_tail(instrs, leaves, avals, out_slot, gshape, sa, sb, comm, tile_bytes):
    """Split-boundary terminator (``fusion.register_split_terminator``): the
    shards, in split ``sb``, of a pending chain whose root is split ``sa``,
    or None to decline (heat_tpu :855).  Accepted: every op a registered
    shape-preserving map, every leaf a full-shape array split along ``sa``
    on this mesh or a one-element scalar, every full-shape op fed by a
    full-shape child, a full-shape root.  Reductions, ``where=`` masks,
    broadcast operands and replicated or foreign-split leaves decline.

    The columns of ``sb`` are cut into bands of :func:`tile_plan`'s width
    over one source shard's rows; for each source shard and band, the chain
    runs on the shard's view of those columns (its ops, as the program
    would run them, on a one-position array), and the result lands in the
    rows of that source in each destination whose columns the band
    crosses.  Values are the materialize-then-resplit ones bit for bit."""
    from ..core import fusion
    from ..core.dndarray import DNDarray
    from .mesh import MeshComm

    gshape = tuple(int(d) for d in gshape)
    if not resplit_applicable(gshape, sa, sb, comm) or instrs[out_slot][0] != "O":
        return None
    kinds = []
    for lf in leaves:
        a, v = lf.aval, lf.value
        if a.array and a.shape == gshape:
            if v.split != sa or v.comm.size != comm.size:
                return None
            kinds.append("full")
        elif math.prod(a.shape) == 1 and (not a.array or v.split is None):
            kinds.append("scalar")
        else:
            return None
    for i, ins in enumerate(instrs):
        if ins[0] != "O":
            continue
        _, fn, kw, ch = ins
        if not _tail_op_ok(fn, kw):
            return None
        shp = tuple(avals[i].shape)
        if shp == gshape:
            if not any(tuple(avals[c].shape) == gshape for c in ch):
                return None
        elif math.prod(shp) != 1:
            return None
    root = avals[out_slot]
    if tuple(root.shape) != gshape:
        return None
    S = comm.size
    itemsize = root.dtype.itemsize
    nelem = math.prod(gshape)
    if _wire.eligible(root.dtype, nelem * itemsize) and _wire.consume(
        "resplit", (gshape, int(sa), int(sb), S, autotune.dtype_name(root.dtype))
    ):
        return None
    full = [lf.value for lf, k in zip(leaves, kinds) if k == "full"]
    sanitize.check_use([t for v in full for t in v.shards], "transport.fused_tail")
    one = MeshComm(1)
    program = fusion._Program(instrs, (out_slot,), tuple(lf.aval for lf in leaves))
    pa = -(-gshape[sa] // S)
    rest = math.prod(e for d, e in enumerate(gshape) if d not in (sa, sb))
    n_sb = gshape[sb]
    like = full[0].shards[0]
    row_bounds = _bounds(gshape[sa], S)
    dst_bounds = _bounds(n_sb, S)

    def view(v, kind, r, c0, c1):
        if kind == "scalar":
            if not isinstance(v, DNDarray):
                return v
            return DNDarray._unledgered(v.shards[:1], v.gshape, v.dtype, None, v.device, one)
        t = v.shards[r].narrow(sb, c0, c1 - c0)
        return DNDarray._unledgered([t], tuple(t.shape), v.dtype, None, v.device, one)

    def run(tb):
        # a band spans destinations: a program run per (source, band), with
        # the tile budget over the source's rows, not per (destination, tile)
        band, _ = tile_plan(n_sb, pa * rest * itemsize, tb)
        out = []
        for lo, hi in dst_bounds:
            dshape = list(gshape)
            dshape[sb] = hi - lo
            out.append(torch.empty(dshape, dtype=root.dtype, device=like.device))
        for r, (r0, r1) in enumerate(row_bounds):
            if r1 <= r0:
                continue
            for c0 in range(0, n_sb, band):
                c1 = min(n_sb, c0 + band)
                vals = [view(lf.value, k, r, c0, c1) for lf, k in zip(leaves, kinds)]
                piece = program.run(vals)[0].shards[0]
                for dst, (lo, hi) in zip(out, dst_bounds):
                    a, b = max(lo, c0), min(hi, c1)
                    if a < b:
                        dst.narrow(sa, r0, r1 - r0).narrow(sb, a - lo, b - a).copy_(piece.narrow(sb, a - c0, b - a))
        return out

    fp = None
    if telemetry.ledger_enabled():
        n_ops = sum(1 for ins in instrs if ins[0] == "O")
        in_bytes = sum(math.prod(lf.aval.shape) * lf.aval.dtype.itemsize for lf in leaves)
        fp = telemetry.fingerprint(("fused_tail", gshape, int(sa), int(sb), S,
                                    fusion._program_fingerprint(instrs, (out_slot,)), str(root.dtype)))
        telemetry.ensure_program(fp, kind="fused_resplit_tail", ops=n_ops, flops=float(n_ops * nelem),
                                 hbm_bytes=float(in_bytes + nelem * itemsize), mesh={"devices": S},
                                 dtype=str(root.dtype))
    with telemetry.span("transport.resplit"):
        out = _with_oom_backoff("resplit", run, tile_bytes, fp=fp, device=like.device)
    _link("resplit")
    memtrack.register_shards(out, tag="output", split=sb)
    out = guard.corrupt("transport.resplit", out)
    _STATS["fused_tails"] += 1
    telemetry.record_event("fused_tail", old_split=int(sa), new_split=int(sb), ops=len(instrs))
    return out


_FUSED_TAIL_REGISTERED = False


def ensure_fused_tail_registered() -> None:
    """Register :func:`_lower_split_tail` with the fusion engine once (the
    engine calls this at its first split boundary, so the core never
    imports the parallel package at load)."""
    global _FUSED_TAIL_REGISTERED
    if _FUSED_TAIL_REGISTERED:
        return
    from ..core import fusion

    fusion.register_split_terminator(_lower_split_tail)
    _FUSED_TAIL_REGISTERED = True


def stats() -> dict:
    """The ``transport`` counter group."""
    return telemetry.snapshot_group("transport")


def reset_stats() -> None:
    telemetry.reset_group("transport")
