"""Ring-scheduled sharded GEMM with fused epilogues (counterpart of
heat_tpu/parallel/overlap.py).

The three sharded 2-D GEMM cases run as ring schedules over the shard list,
each position's step computed on its own shard:

``ag``   A row-split x B row-split -> out row-split.  A's row block stays;
         B's k-blocks rotate by ``collectives.ring_shift``, and position
         ``me`` adds ``a[:, src] @ blk`` with ``src = (me - t) mod S`` at
         step ``t``.
``rs``   A col-split x B row-split (the inner dimension split) -> out
         row-split, col-split or replicated.  The accumulator travels: it
         starts as ``partial((me - 1) mod S)`` and each hop does
         ``acc = shift(acc) + partial((me - t - 1) mod S)``; a replicated
         out-split all-gathers the blocks.
``col``  A col-split x B col-split -> out col-split, the mirror of ``ag``.

The local block products are ``torch.matmul`` (heat_tpu computes them with
``lax.dot_general`` outside any Pallas kernel), in IEEE float32 with TF32
off; 16-bit operands multiply on the tensor cores with a float32 result
and accumulator (heat_tpu's ``preferred_element_type``) and are cast back
before the epilogue.  The port's shards are truncated, not padded: the
last position's short k-block is summed as it is, which is what heat_tpu's
masked, zero-padded block adds up to, in the same order of blocks.  The ``rs`` sum is block-wise, so it
rounds differently from one GEMM.

Every schedule carries an optional fused tail applied to each final local
block: :class:`Epilogue` (``cast(act(scale * (a @ b) + bias))``) for eager
calls, or an elementwise chain captured from the fusion DAG (a chain
``tail(... (a @ b))`` lowers here through the registered terminator,
:func:`_lower_chain`).

Dispatch: ``HEAT_TPU_MATMUL=auto|gspmd|ring`` (``auto`` rings above
``HEAT_TPU_MATMUL_RING_MIN_BYTES`` moved over the ring); with the tuning
plane on, ``auto`` explores both arms per GEMM geometry (the ring and the
port's eager layout code in ``core/linalg/basics.py``, the counterpart of
GSPMD's einsum) and keeps the faster.  A staging check against measured
free device memory declines the ring before it can run out of memory.
:func:`matmul_raw` returns ``None`` where heat_tpu's does, and the caller
runs its own product.  :func:`stats` keeps heat_tpu's counters.

On one card the positions share the H100: a ring hop is a rotation of the
shard list and moves no bytes over a link, so the ring measures block-GEMM
efficiency and host dispatch, never the overlap of a transfer with compute.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..analysis import program_audit, sanitize
from ..core import autotune, memtrack, telemetry
from ..core import wire as _wire
from . import collectives

__all__ = [
    "Epilogue",
    "matmul",
    "matmul_raw",
    "ring_sweep",
    "stats",
    "reset_stats",
    "set_mode",
]


# ------------------------------------------------------------------ dispatch

_VALID_MODES = ("auto", "gspmd", "ring")
_RING_MIN_BYTES_DEFAULT = 1 << 20  # 1 MiB moved over the ring
# staging admission: the ring's residency (both operands and the
# accumulator) may spend at most this fraction of measured free memory
_STAGING_FRACTION = 0.5
_MODE_OVERRIDE: Optional[str] = None

# decision reasons that make the ring impossible (not merely dispreferred):
# the tuning plane never second-guesses these
_RING_IMPOSSIBLE = ("layout", "mesh1", "out-split")


def set_mode(mode: Optional[str]) -> Optional[str]:
    """Process-wide override of ``HEAT_TPU_MATMUL`` (``None`` restores the
    environment variable).  Returns the previous override."""
    global _MODE_OVERRIDE
    if mode is not None and mode not in _VALID_MODES:
        raise ValueError(f"mode must be one of {_VALID_MODES}, got {mode!r}")
    prev = _MODE_OVERRIDE
    _MODE_OVERRIDE = mode
    return prev


def _mode() -> str:
    if _MODE_OVERRIDE is not None:
        return _MODE_OVERRIDE
    raw = os.environ.get("HEAT_TPU_MATMUL", "auto").strip().lower()
    return raw if raw in _VALID_MODES else "auto"


def _ring_min_bytes() -> int:
    # a malformed value raises instead of silently running the default
    return autotune.env_bytes("HEAT_TPU_MATMUL_RING_MIN_BYTES", _RING_MIN_BYTES_DEFAULT)


def _dispatch_salt() -> tuple:
    """Joins the fusion cache key: a flipped mode, threshold or wire knob
    builds a distinct program instead of reusing the other one's."""
    return ("overlap", _mode(), _ring_min_bytes(), _wire.mode(), _wire.min_bytes())


def _links(*shard_lists) -> bool:
    """Whether the positions' tensors span more than one device, so that a
    ring hop moves bytes over a link (the wire plane's ``links``)."""
    return len({t.device for shards in shard_lists for t in shards}) > 1


def _ceil_mult(n: int, s: int) -> int:
    return -(-n // s) * s


def _classify(a_split: Optional[int], b_split: Optional[int]) -> Optional[str]:
    if a_split == 0 and b_split == 0:
        return "ag"
    if a_split == 1 and b_split == 0:
        return "rs"
    if a_split == 1 and b_split == 1:
        return "col"
    return None


def _decide(case, out_split, m, k, n, S, comp_isz, acc_isz):
    """Schedule decision (heat_tpu :158): ``(use_ring, reason,
    bytes_per_step)``.  bytes/step is one ring hop's moving operand block
    (``ag``/``col``) or travelling accumulator (``rs``), at heat_tpu's even
    chunk; ``auto`` rings only when the ring's total traffic clears the
    threshold."""
    if case is None:
        return False, "layout", 0
    if S <= 1:
        return False, "mesh1", 0
    if case == "ag" and out_split != 0:
        return False, "out-split", 0
    if case == "col" and out_split != 1:
        return False, "out-split", 0
    if case == "ag":
        bps = (_ceil_mult(k, S) // S) * n * comp_isz
    elif case == "col":
        bps = m * (_ceil_mult(k, S) // S) * comp_isz
    elif out_split == 1:
        bps = m * (_ceil_mult(n, S) // S) * acc_isz
    else:
        bps = (_ceil_mult(m, S) // S) * n * acc_isz
    mode = _mode()
    if mode == "gspmd":
        return False, "mode=gspmd", bps
    if mode == "ring":
        return True, "mode=ring", bps
    if bps * (S - 1) < _ring_min_bytes():
        return False, "below-threshold", bps
    return True, "auto", bps


# --------------------------------------------------------------------- stats

_SEEN: set = set()

_STATS = telemetry.register_group(
    "overlap",
    {
        "calls": 0,
        "ring_calls": 0,
        "gspmd_calls": 0,
        "ring_builds": 0,
        "cache_hits": 0,
        "by_schedule": {"ring_ag": 0, "ring_rs": 0, "ring_col": 0, "gspmd": 0},
        "last": None,
    },
    on_reset=_SEEN.clear,
)


def stats() -> dict:
    """Dispatcher counters (heat_tpu's keys): ``calls``, ``ring_calls`` /
    ``gspmd_calls``, ``ring_builds`` (first runs of a schedule),
    ``cache_hits`` (eager ring calls of a schedule seen before; a fused
    chain's reuse is counted by ``fusion.cache_stats()``), ``by_schedule``
    and ``last``: the latest decision's schedule, steps, bytes/step,
    out-split and reason.  The same counters appear in
    ``telemetry.snapshot()``."""
    return telemetry.snapshot_group("overlap")


def reset_stats() -> None:
    """Zero the counters and forget the schedules seen."""
    telemetry.reset_group("overlap")


def _record(schedule, *, steps=0, bps=0, out_split=None, reason="", cache_hit=False):
    _STATS["calls"] += 1
    if schedule == "gspmd":
        _STATS["gspmd_calls"] += 1
    else:
        _STATS["ring_calls"] += 1
        if cache_hit:
            _STATS["cache_hits"] += 1
        else:
            _STATS["ring_builds"] += 1
    _STATS["by_schedule"][schedule] += 1
    _STATS["last"] = {
        "schedule": schedule, "steps": steps, "bytes_per_step": bps,
        "out_split": out_split, "reason": reason,
    }
    telemetry.record_event(
        "matmul_dispatch", schedule=schedule, steps=steps, bytes_per_step=bps,
        out_split=out_split, reason=reason, cache_hit=cache_hit,
    )


# ---------------------------------------------------------------- ring sweep

def _shift(moving: list) -> list:
    """One hop up the ring for a list of per-position items (a tensor, or a
    tuple of tensors that hop together)."""
    if isinstance(moving[0], tuple):
        cols = [collectives.ring_shift([item[i] for item in moving]) for i in range(len(moving[0]))]
        return [tuple(c[me] for c in cols) for me in range(len(moving))]
    return collectives.ring_shift(moving)


def ring_sweep(n_steps: int, moving: list, state: list, step: Callable) -> list:
    """The ring schedule over the shard list (heat_tpu :259): for each of
    ``n_steps`` steps every position ``me`` computes ``state[me] = step(t,
    me, moving[me], state[me])`` on the block it holds, and the blocks hop
    one position up the ring (``collectives.ring_shift``) before the next
    step; the final, useless hop is elided.  ``moving`` items may be tuples
    whose tensors hop together (a quantized block and its scales)."""
    for t in range(n_steps):
        nxt = _shift(moving) if t + 1 < n_steps else None
        state = [step(t, me, moving[me], state[me]) for me in range(len(state))]
        moving = nxt
    return state


def _bounds(extent: int, S: int, r: int) -> Tuple[int, int]:
    """Position ``r``'s [lo, hi) of ``extent`` under the chunk rule (even
    ceil chunks, trailing ones truncated)."""
    per = -(-extent // S) if extent > 0 else 0
    return min(r * per, extent), min((r + 1) * per, extent)


# ----------------------------------------------------------------- epilogue

def _cast(x, dtype):
    return x.to(dtype)


def _apply_steps(blk, steps, extras):
    for fn, kw, pat in steps:
        blk = fn(*[blk if p < 0 else extras[p] for p in pat], **dict(kw))
    return blk


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from ..core import types

    return types.canonical_heat_type(dtype).torch_type()


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    from ..core.dndarray import DNDarray

    if isinstance(value, DNDarray):
        return value.larray
    return torch.as_tensor(value)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Fused matmul tail for eager calls, applied to each final local block
    of the ring: ``out = cast(act(scale * (a @ b) + bias))`` (``None``
    fields are skipped).  ``scale`` and ``bias`` broadcast against the 2-D
    result (a tensor, a number or an array); ``activation`` is an
    elementwise callable on tensors (e.g. ``torch.relu``); ``dtype`` a heat
    type, a torch dtype or a name."""

    scale: Any = None
    bias: Any = None
    activation: Optional[Callable] = None
    dtype: Any = None

    def __post_init__(self):
        # fail at construction, not inside a ring step
        for name in ("scale", "bias"):
            value = getattr(self, name)
            if value is None:
                continue
            try:
                arr = _as_tensor(value)
            except (TypeError, ValueError, RuntimeError) as exc:
                raise TypeError(
                    f"Epilogue.{name} must be numeric/array-like (got {type(value).__name__}): {exc}"
                ) from None
            if arr.dtype == torch.bool:
                raise TypeError(f"Epilogue.{name} must be numeric, got dtype {arr.dtype}")
            if arr.ndim > 2:
                raise ValueError(
                    f"Epilogue.{name} must be scalar, 1-D, or 2-D — it broadcasts against the 2-D matmul "
                    f"result; got ndim={arr.ndim} (shape {tuple(arr.shape)})"
                )
        if self.activation is not None and not callable(self.activation):
            raise TypeError(f"Epilogue.activation must be a callable, got {type(self.activation).__name__}")
        if self.dtype is not None:
            try:
                _torch_dtype(self.dtype)
            except (TypeError, ValueError):
                raise TypeError(f"Epilogue.dtype is not a dtype: {self.dtype!r}") from None

    def lower(self):
        """``(steps, extras)``: each step ``(fn, static_kwargs_items,
        arg_pattern)``, ``-1`` in the pattern marking the flowing block and
        ``i >= 0`` an extras tensor."""
        steps, extras = [], []
        if self.scale is not None:
            extras.append(_as_tensor(self.scale))
            steps.append((torch.mul, (), (-1, len(extras) - 1)))
        if self.bias is not None:
            extras.append(_as_tensor(self.bias))
            steps.append((torch.add, (), (-1, len(extras) - 1)))
        if self.activation is not None:
            steps.append((self.activation, (), (-1,)))
        if self.dtype is not None:
            steps.append((_cast, (("dtype", _torch_dtype(self.dtype)),), (-1,)))
        return tuple(steps), tuple(extras)


def _check_extras(extras, gshape, out_split) -> None:
    """Each epilogue extra must broadcast against the GLOBAL 2-D result:
    along every axis its extent is 1 or the result's (heat_tpu :368)."""
    for i, value in enumerate(extras):
        es = tuple(value.shape)
        if len(es) > 2:
            raise ValueError(f"epilogue extra {i} (shape {es}) cannot broadcast against the 2-D matmul result "
                             f"{tuple(gshape)}")
        for off in range(1, len(es) + 1):
            ext, full = es[-off], gshape[-off]
            if ext in (1, full):
                continue
            res_ax = len(gshape) - off
            sliced = out_split is not None and res_ax == out_split
            raise ValueError(
                f"epilogue extra {i} has shape {es}: axis {len(es) - off} has length {ext}, expected 1 or the "
                f"full result extent {full} (result axis {res_ax} of {tuple(gshape)}"
                + (", sliced per ring block along the out-split)" if sliced else ")")
            )


def _extra_axes(extra_shapes, gshape, out_split) -> tuple:
    """Per extra, the axis that follows the out-split (sliced per block), or
    None where the extra broadcasts along it (heat_tpu :397)."""
    axes = []
    for es in extra_shapes:
        eax = None
        if out_split is not None and es:
            ax = out_split - (len(gshape) - len(es))
            if 0 <= ax < len(es) and es[ax] == gshape[out_split] and es[ax] > 1:
                eax = ax
        axes.append(eax)
    return tuple(axes)


def _tail(blk, steps, extras, extra_axes, split, gshape, S, me):
    """The epilogue on position ``me``'s block of a result split along
    ``split``: each extra that follows the split is cut to the block."""
    if extras:
        ex = []
        for v, eax in zip(extras, extra_axes):
            if eax is not None:
                lo, hi = _bounds(gshape[split], S, me)
                v = v.narrow(eax, lo, hi - lo)
            ex.append(v.to(blk.device))
        extras = ex
    return _apply_steps(blk, steps, extras)


# -------------------------------------------------------------- ring programs

class _Spec(NamedTuple):
    """Identity of one ring program: the schedule, the geometry, the dtypes
    and the epilogue's steps (extra values are runtime operands)."""

    case: str
    out_split: Optional[int]
    S: int
    m: int
    k: int
    n: int
    comp_dt: torch.dtype   # dtype both operands are cast to
    acc_dt: torch.dtype    # block accumulator (f32 for 16-bit inputs)
    steps: tuple
    extra_axes: tuple
    wire: str = ""         # on-wire format of the moving block ("" | int8 | fp8)


def _build_ring(spec: _Spec) -> Callable:
    """The ring program of one :class:`_Spec`: ``program(a_shards,
    b_shards, *extras) -> out_shards`` (one block a position; for a
    replicated out-split the same tensor at every position)."""
    case, out_split, S = spec.case, spec.out_split, spec.S
    m, k, n = spec.m, spec.k, spec.n
    comp, acc_dt = spec.comp_dt, spec.acc_dt
    kb = _ceil_mult(k, S) // S  # heat_tpu's k-block: position r's k-slice starts at r * kb

    def _dot(x, y):
        if x.dtype == acc_dt:
            return torch.matmul(x, y)
        if x.is_cuda:
            # 16-bit operands on the tensor cores with an f32 result
            # (heat_tpu's bf16 MXU product with preferred_element_type)
            return torch.mm(x, y, out_dtype=acc_dt)
        # the CPU has no 16-bit product with an f32 result: widening first
        # gives the same exact products, summed in f32
        return torch.matmul(x.to(acc_dt), y.to(acc_dt))

    def _finish(blk, extras, me):
        return _tail(blk.to(comp), spec.steps, extras, spec.extra_axes, out_split, (m, n), S, me)

    def _k_slice(t: torch.Tensor, dim: int, src: int) -> torch.Tensor:
        lo, hi = _bounds(k, S, src)
        return t.narrow(dim, lo, hi - lo)

    def _decode(moving, axes):
        if spec.wire:
            return _wire.absmax_decode(moving[0], moving[1], axes, comp)
        return moving

    if case == "ag":
        def program(a_sh, b_sh, *extras):
            av = [s.to(comp) for s in a_sh]                       # (mb_me, k)
            bv = [s.to(comp) for s in b_sh]                       # (kb_r, n)
            moving = [_wire.absmax_encode(v, spec.wire, (0,)) for v in bv] if spec.wire else bv
            acc0 = [v.new_zeros((v.shape[0], n), dtype=acc_dt) for v in av]

            def step(t, me, blk, acc):
                src = (me - t) % S
                return acc + _dot(_k_slice(av[me], 1, src), _decode(blk, (0,)))

            acc = ring_sweep(S, moving, acc0, step)
            return [_finish(a, extras, me) for me, a in enumerate(acc)]

    elif case == "col":
        def program(a_sh, b_sh, *extras):
            av = [s.to(comp) for s in a_sh]                       # (m, kb_r)
            bv = [s.to(comp) for s in b_sh]                       # (k, nb_me)
            moving = [_wire.absmax_encode(v, spec.wire, (1,)) for v in av] if spec.wire else av
            acc0 = [v.new_zeros((m, v.shape[1]), dtype=acc_dt) for v in bv]

            def step(t, me, blk, acc):
                src = (me - t) % S
                return acc + _dot(_decode(blk, (1,)), _k_slice(bv[me], 0, src))

            acc = ring_sweep(S, moving, acc0, step)
            return [_finish(a, extras, me) for me, a in enumerate(acc)]

    else:  # rs: the inner dimension split; the accumulator travels
        eff = 1 if out_split == 1 else 0

        def program(a_sh, b_sh, *extras):
            av = [s.to(comp) for s in a_sh]                       # (m, kb_me)
            bv = [s.to(comp) for s in b_sh]                       # (kb_me, n)

            def partial_(me, d):
                lo, hi = _bounds(m if eff == 0 else n, S, d)
                if eff == 0:
                    return _dot(av[me].narrow(0, lo, hi - lo), bv[me])
                return _dot(av[me], bv[me].narrow(1, lo, hi - lo))

            # position r starts the accumulator bound for r - 1 and passes it
            # one position up each step: after S - 1 hops every accumulator
            # has reached its destination with all S contributions
            acc = [partial_(me, (me - 1) % S) for me in range(S)]
            for t in range(1, S):
                sent = collectives.ring_shift(acc)
                acc = [sent[me] + partial_(me, (me - t - 1) % S) for me in range(S)]
            if out_split is None:
                full = _finish(collectives.all_gather(acc, dim=0)[0], extras, 0)
                return [full] * S
            return [_finish(a, extras, me) for me, a in enumerate(acc)]

    return program


def _spec_for(S, case, out_split, m, k, n, comp, steps, extra_axes, wire=""):
    half = comp.is_floating_point and comp.itemsize < 4
    acc = torch.float32 if half else comp
    return _Spec(case, out_split, S, m, k, n, comp, acc, steps, extra_axes, wire)


def _acc_itemsize(comp: torch.dtype) -> int:
    return 4 if (comp.is_floating_point and comp.itemsize < 4) else comp.itemsize


def _gspmd_reference(spec: _Spec, a_split, b_split) -> Callable:
    """The competing arm of an explore call: the port's eager layout code
    (``core/linalg/basics.py``, the counterpart of GSPMD's einsum) on the
    same shards, with the same epilogue applied to the whole result."""
    from ..core.linalg import basics

    def ref(a_sh, b_sh, *extras):
        shards, split = basics._matmul_shards(a_sh, a_split, b_sh, b_split, spec.m, spec.k, spec.n, spec.S,
                                              spec.comp_dt)
        axes = _extra_axes([tuple(v.shape) for v in extras], (spec.m, spec.n), split)
        return [_tail(s, spec.steps, extras, axes, split, (spec.m, spec.n), spec.S, me) for me, s in enumerate(shards)]

    return ref


def matmul_raw(comm, a, b, lshape_a, lshape_b, a_split, b_split, out_split=None, *, comp_dtype=None,
               epilogue: Optional[Epilogue] = None, precision=None, exact: bool = False):
    """Shard-list entry of the engine (heat_tpu :663), for callers that
    hold per-position tensors (``linalg.qr``, ``cluster.kmeans``,
    ``quantize``): dispatch one 2-D sharded GEMM of ``a`` (the
    ``lshape_a`` array split along ``a_split``, one tensor a position) by
    ``b``, returning the result's tensor a position in ``out_split`` — or
    ``None`` where the dispatcher takes the other arm and the caller runs
    its own product.

    The ``ag``/``col`` rings may move their block on a quantized wire
    (``core/wire.py``), a second tuning axis consulted once the
    ring-against-eager entry has stopped exploring; ``exact=True`` pins the
    f32 wire, and ``rs`` declines (its travelling partial sum cannot be
    re-quantized at every hop).  ``precision`` is accepted for parity:
    products are IEEE float32."""
    a, b = list(a), list(b)
    sanitize.check_use(a, "overlap.matmul_raw")
    sanitize.check_use(b, "overlap.matmul_raw")
    m, k = lshape_a
    k2, n = lshape_b
    if k != k2:
        raise ValueError(f"inner dims disagree: {lshape_a} @ {lshape_b}")
    case = _classify(a_split, b_split)
    comp = _torch_dtype(comp_dtype) if comp_dtype is not None else torch.promote_types(a[0].dtype, b[0].dtype)
    steps, extras = epilogue.lower() if epilogue is not None else ((), ())
    if extras:
        _check_extras(extras, (m, n), out_split)
    acc_isz = _acc_itemsize(comp)
    S_ = comm.size
    use, reason, bps = _decide(case, out_split, m, k, n, S_, comp.itemsize, acc_isz)
    # the tuning plane: in auto mode the byte threshold is only a prior;
    # the first calls of a geometry run both arms under measurement
    tune = None
    if reason not in _RING_IMPOSSIBLE and _mode() == "auto" and autotune.enabled():
        dt = autotune.dtype_name(comp)
        tune_key = autotune.matmul_key(case, out_split, m, k, n, S_, dt)
        per_dev = ((m * k + k * n) * comp.itemsize + m * n * acc_isz) // S_
        granted = memtrack.suggest_budget(per_dev, fraction=_STAGING_FRACTION)
        if granted is not None and granted < per_dev:
            autotune.note_staging_decline(tune_key, per_dev, granted)
            _record("gspmd", steps=0, bps=bps, out_split=out_split, reason="hbm-budget")
            return None
        tune = autotune.decide(tune_key, "ring" if use else "gspmd", desc=f"{case} {m}x{k}x{n} {dt} S={S_}")
        if tune.explore:
            use, reason = True, "autotune:explore"
        else:
            use = tune.arm == "ring"
            reason = "autotune:" + tune.source
    if not use:
        _record("gspmd", steps=0, bps=bps, out_split=out_split, reason=reason)
        return None

    # the wire axis, consulted only once the ring entry has stopped
    # exploring, so that one explore measures one variable
    kb_ = _ceil_mult(k, S_) // S_
    wire_arm, wire_d, wm = "wire_f32", None, ""
    if case == "rs":
        _wire.decline("ring_rs")
    elif not (tune is not None and tune.explore) and _wire.eligible(comp, bps * (S_ - 1), exact=exact):
        wire_arm, wire_d = _wire.choose("ring_" + case, (m, k, n, S_, autotune.dtype_name(comp)),
                                        desc=f"ring_{case} {m}x{k}x{n} {autotune.dtype_name(comp)} S={S_}",
                                        links=_links(a, b))
        if wire_d is None or not wire_d.explore:
            wm = "" if wire_arm == "wire_f32" else wire_arm[len("wire_"):]
    wire_elems = (kb_ * n if case == "ag" else m * kb_) * (S_ - 1)

    def wire_total(w):
        return _wire.payload_nbytes(wire_elems, kb_ * (S_ - 1), w)

    extra_axes = _extra_axes([tuple(v.shape) for v in extras], (m, n), out_split)
    spec = _spec_for(S_, case, out_split, m, k, n, comp, steps, extra_axes, wire=wm)
    memtrack.register_shards(a, tag="staging")
    memtrack.register_shards(b, tag="staging")
    hit = spec in _SEEN
    _SEEN.add(spec)
    dt = autotune.dtype_name(comp)
    fp_parts = ("ring", case, out_split, m, k, n, dt, len(steps))
    if wm:
        fp_parts = ("ring_wire",) + fp_parts[1:] + (wm,)
    ring_fp = telemetry.fingerprint(fp_parts) if telemetry.ledger_enabled() else None
    device = a[0].device
    with telemetry.span("overlap.ring_" + case, m=m, k=k, n=n):
        fn = _build_ring(spec)
        if program_audit.enabled():
            fn = program_audit.watched("ring_" + case, ring_fp, fn, expect="any")
        if tune is not None and tune.explore:
            # explore: both arms under measurement, the ring's result
            # returned (the arms agree within rounding)
            if hit:
                telemetry.program_hit(ring_fp)
            out, ring_s = autotune.timed(fn, a, b, *extras)
            if hit:
                telemetry.record_timing(ring_fp, ring_s)
            autotune.observe(tune.key, "ring", ring_s)
            _, gspmd_s = autotune.timed(_gspmd_reference(spec, a_split, b_split), a, b, *extras)
            autotune.observe(tune.key, "gspmd", gspmd_s)
        elif wire_d is not None and wire_d.explore:
            # the f32 ring and both quantized rings under measurement; the
            # f32 result is returned
            if hit:
                telemetry.program_hit(ring_fp)

            def run_for(wmx):
                if not wmx:
                    return fn(a, b, *extras)
                return _build_ring(spec._replace(wire=wmx))(a, b, *extras)

            out = _wire.explore(wire_d, run_for)
        elif hit:
            # steady state: the ledger's hit and a sampled time, watched by
            # the tuned entries' degradation observers
            telemetry.program_hit(ring_fp)
            obs_list = []
            if tune is not None:
                obs_list.append(functools.partial(autotune.observe, tune.key, "ring"))
            if wm and wire_d is not None:
                obs_list.append(functools.partial(autotune.observe, wire_d.key, wire_arm))
            observer = (lambda dur_s: [o(dur_s) for o in obs_list]) if obs_list else None
            out = telemetry.timed_call(ring_fp, fn, a, b, *extras, observer=observer, device=device)
        else:
            out = fn(a, b, *extras)
    if wm:
        _wire.account("ring_" + case, wire_arm, bps * (S_ - 1), wire_total(wm))
    memtrack.register_shards(out, tag="output", split=out_split)
    sanitize.collective_event("ring_" + case, site="overlap.matmul_raw")
    _record("ring_" + case, steps=S_, bps=bps, out_split=out_split, reason=reason, cache_hit=hit)
    # the program's work: the GEMM's operations and each operand read and
    # the result written once (a hop's bytes cross a link, not memory)
    if not hit and ring_fp is not None:
        extra_kw = {}
        if wm:
            extra_kw = dict(wire=wm, logical_bytes=float(bps * (S_ - 1)), wire_bytes=float(wire_total(wm)))
        telemetry.record_program(
            ring_fp, kind="ring_matmul", ops=1 + len(steps), flops=2.0 * m * k * n,
            hbm_bytes=float((m * k + k * n) * comp.itemsize + m * n * acc_isz), mesh={"devices": S_},
            schedule="ring_" + case, bytes_per_step=bps, dtype=dt, **extra_kw,
        )
    return out


def matmul(a, b, out_split="auto", *, epilogue: Optional[Epilogue] = None, precision=None, exact: bool = False):
    """DNDarray entry (heat_tpu :900): ring-dispatch ``a @ b`` (2-D),
    returning the result DNDarray, or ``None`` where the dispatcher takes
    the eager arm (the caller runs its own product).  ``out_split="auto"``
    follows the convention (row-split a -> 0, col-split b -> 1, an inner
    split -> replicated); ``rs`` honours any explicit request."""
    from ..core import types
    from ..core.dndarray import DNDarray

    if a.ndim != 2 or b.ndim != 2 or (a.comm is not b.comm and a.comm.size != b.comm.size):
        _record("gspmd", reason="layout")
        return None
    if out_split == "auto":
        out_split = 0 if a.split == 0 else (1 if b.split == 1 else None)
    comp = types.promote_types(a.dtype, b.dtype).torch_type()
    steps, extras = epilogue.lower() if epilogue is not None else ((), ())
    m, k = a.shape
    n = b.shape[1]
    if steps:
        _check_extras(extras, (m, n), out_split)
        probe = _apply_steps(torch.empty((m, n), dtype=comp, device="meta"), steps,
                             [e.to("meta") for e in extras])
        if tuple(probe.shape) != (m, n):
            raise ValueError(f"epilogue changes the result shape to {tuple(probe.shape)}")
        out_dt = probe.dtype
    else:
        out_dt = comp
    out = matmul_raw(a.comm, a.shards, b.shards, (m, k), (k, n), a.split, b.split, out_split, comp_dtype=comp,
                     epilogue=epilogue, precision=precision, exact=exact)
    if out is None:
        return None
    return DNDarray(out, (m, n), types.canonical_heat_type(out_dt), out_split, a.device, a.comm)


# ------------------------------------------------- fusion chain terminator

def _mm(a, b):
    """The matmul node of the fusion DAG: the eager layout code
    (``core/linalg/basics.py``).  A generic program evaluates it where the
    terminator declines, so correctness never depends on the match."""
    from ..core import types
    from ..core.linalg import basics

    return basics._matmul_2d(a, b, types.promote_types(a.dtype, b.dtype).torch_type())


# chain ops that may ride the ring as its tail: shape-preserving and
# value-wise; reductions, scans and composites take the generic program
_CHAIN_KINDS = {"elementwise", "cast", "comparison", "predicate"}

_REGISTERED = False


def ensure_registered() -> None:
    """Register ``_mm``, the chain terminator and the tuning plane's salt
    with the fusion engine, once."""
    global _REGISTERED
    if _REGISTERED:
        return
    from ..core import fusion

    fusion.register_op(_mm, "matmul", kind="matmul")
    fusion.register_terminator(_lower_chain, salt=_dispatch_salt)
    # a winner resolving, a cache load or an enable toggle builds distinct
    # fused programs: the tuning plane's generation joins every cache key
    fusion.register_cache_salt(autotune.salt)
    _REGISTERED = True


def _chain_operand(instrs, c):
    """A ``_mm`` operand slot: a leaf, optionally through one cast.  ->
    ``(leaf_index, cast_dtype_or_None)`` or None."""
    from ..core import fusion

    ins = instrs[c]
    if ins[0] == "L":
        return ins[1], None
    _, fn, kw, ch = ins
    if fn is fusion._astype and len(ch) == 1 and instrs[ch[0]][0] == "L":
        return instrs[ch[0]][1], _torch_dtype(dict(kw)["dtype"])
    return None


def _lower_chain(instrs, leaves, out_slot, gshape, split, comm, with_guard):
    """Fusion terminator (heat_tpu :1009): recognise ``tail(...(_mm(a,
    b)))`` and return a program that runs the ring with the elementwise
    tail applied to its result, or ``None`` to decline (the generic program
    then evaluates the chain op by op)."""
    from ..core import fusion, types
    from ..core.dndarray import DNDarray

    if len(gshape) != 2:
        return None
    if not any(ins[0] == "O" and ins[1] is _mm for ins in instrs):
        return None
    # walk root -> _mm, collecting the elementwise tail
    tail = []
    slot = out_slot
    while True:
        ins = instrs[slot]
        if ins[0] != "O":
            return None
        _, fn, kw, ch = ins
        if fn is _mm:
            mm_ch = ch
            break
        if fn not in fusion._OP_TABLE or fusion._meta(fn, kw)[1] not in _CHAIN_KINDS:
            return None
        nxt = {c for c in ch if instrs[c][0] == "O"}
        if len(nxt) != 1:
            return None
        tail.append((fn, kw, ch, slot))
        slot = nxt.pop()
    if len(mm_ch) != 2:
        return None
    opa = _chain_operand(instrs, mm_ch[0])
    opb = _chain_operand(instrs, mm_ch[1])
    if opa is None or opb is None:
        return None
    ia, cast_a = opa
    ib, cast_b = opb
    la, lb = leaves[ia].aval.shape, leaves[ib].aval.shape
    if len(la) != 2 or len(lb) != 2 or la[1] != lb[0]:
        return None
    m, k = la
    n = lb[1]
    if tuple(gshape) != (m, n):
        return None
    S = comm.size
    a_val, b_val = leaves[ia].value, leaves[ib].value
    a_split = a_val.split if isinstance(a_val, DNDarray) and a_val.comm.size == S else None
    b_split = b_val.split if isinstance(b_val, DNDarray) and b_val.comm.size == S else None
    case = _classify(a_split, b_split)
    if case is None:
        _record("gspmd", out_split=split, reason="layout")
        return None
    comp = torch.promote_types(cast_a or leaves[ia].aval.dtype, cast_b or leaves[ib].aval.dtype)
    acc_isz = _acc_itemsize(comp)
    use, reason, bps = _decide(case, split, m, k, n, S, comp.itemsize, acc_isz)
    # a chain consumes tuning state and never explores: running both arms
    # would run the whole chain twice
    if reason not in _RING_IMPOSSIBLE and _mode() == "auto" and autotune.enabled():
        key = autotune.matmul_key(case, split, m, k, n, S, autotune.dtype_name(comp))
        w = autotune.winner(key)
        if w is not None:
            use, reason = w == "ring", "autotune:cached"
        else:
            autotune.note_prior(key, "ring" if use else "gspmd")
    if not use:
        _record("gspmd", bps=bps, out_split=split, reason=reason)
        return None
    # the tail, bottom-up: the chain's slot flows, other operands must be
    # leaves that broadcast against the 2-D result
    chain_slot = slot
    for fn, kw, ch, op_slot in reversed(tail):
        for c in ch:
            if c == chain_slot:
                continue
            if instrs[c][0] != "L":
                return None
            es = leaves[instrs[c][1]].aval.shape
            if len(es) > 2:
                return None
            off = 2 - len(es)
            if any(es[i] not in (1, gshape[i + off]) for i in range(len(es))):
                return None
        chain_slot = op_slot
    # the wire, consume-only: a forced mode or a winner the eager entry
    # resolved on the same key; a guarded chain declines (the guard's
    # verdict must describe the caller's numbers, not quantized hops)
    wire_m = ""
    if case in ("ag", "col"):
        if with_guard:
            _wire.decline("ring_fold")
        else:
            kb_ = _ceil_mult(k, S) // S
            bps_w = (kb_ * n if case == "ag" else m * kb_) * comp.itemsize
            if _wire.eligible(comp, bps_w * (S - 1)):
                wire_m = _wire.consume("ring_" + case, (m, k, n, S, autotune.dtype_name(comp)),
                                       links=_links(a_val.shards, b_val.shards))
    else:
        _wire.decline("ring_rs")
    spec = _spec_for(S, case, split, m, k, n, comp, (), (), wire=wire_m)
    kern = _build_ring(spec)
    if wire_m:
        kb_ = _ceil_mult(k, S) // S
        elems = (kb_ * n if case == "ag" else m * kb_) * (S - 1)
        _wire.account("ring_" + case, "wire_" + wire_m, elems * comp.itemsize,
                      _wire.payload_nbytes(elems, kb_ * (S - 1), wire_m))
    _record("ring_" + case, steps=S, bps=bps, out_split=split, reason=reason)
    out_ht = types.canonical_heat_type(comp)
    mm_slot = slot
    steps = tuple(reversed(tail))

    def program(vals):
        a_v, b_v = vals[ia], vals[ib]
        blocks = kern(a_v.shards, b_v.shards)
        env = {mm_slot: DNDarray(blocks, (m, n), out_ht, split, a_v.device, a_v.comm)}
        for fn, kw, ch, op_slot in steps:
            env[op_slot] = fn(*[env[c] if c in env else vals[instrs[c][1]] for c in ch], **dict(kw or ()))
        return env[out_slot]

    return program
