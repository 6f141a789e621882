"""Wire formats for the movement engines (counterpart of
heat_tpu/core/wire.py): absmax-scaled int8/fp8 payloads for the transfers
between positions.

The format: just before a block leaves its position it is snapped to int8
(or ``float8_e4m3fn``) on an absmax grid with one f32 scale per row of the
block (:func:`absmax_encode`); the payload and its scales travel side by
side and :func:`absmax_decode` lands them back in the payload's dtype.
All-zero rows carry scale 1, so zeros arrive exact.  The grid is
heat_tpu's bit for bit as its jitted programs compute it: an f32 absmax
over the reduced axes, ``scale = absmax · f32(1/qmax)`` (XLA's folding of
``absmax / qmax``), ``x / scale``, then round half to even and clip (int8)
or clip to ±448 and cast (fp8).

Dispatch is a tuning decision over :data:`~heat_tpu_torch.core.autotune.WIRE_ARMS`
per (site, geometry, device kind): ``wire_f32`` is the reference arm, and
an explore call returns its result bitwise.  Exact transfers decline
statically, with no table entry: bool, integer and 1-byte payloads,
transfers below ``HEAT_TPU_WIRE_MIN_BYTES`` (64 KiB by default), row takes
(``transport.tiled_take``) and any caller passing ``exact=True``.

``HEAT_TPU_WIRE`` = ``on`` (the default: the tuned arm per site) | ``off``
(the f32 wire, no decisions) | ``int8`` | ``fp8`` (one arm forced, no
decisions).  Unlike heat_tpu, an arm that raises while exploring raises:
only a missing fp8 dtype forfeits its arm.  The overlap rings (the ring
GEMM and the ring ``cdist``) consult the table only where their positions
span more than one device (``links=True``): with every position on one
card no byte crosses a link, so a quantized arm could only win on timing
noise and would make an exact result approximate; a forced mode still
applies there.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import autotune, telemetry

__all__ = [
    "QMAX",
    "absmax_decode",
    "absmax_encode",
    "account",
    "choose",
    "consume",
    "decline",
    "eligible",
    "explore",
    "fp8_available",
    "min_bytes",
    "mode",
    "payload_nbytes",
    "qdtype",
    "set_mode",
    "stats",
]

# the absmax maps onto the grid's largest representable magnitude
QMAX = {"int8": 127.0, "fp8": 448.0}
# heat_tpu runs the encode inside jitted programs, where XLA folds the
# division by the constant qmax into a multiplication by its f32
# reciprocal; the port computes that form, so its scales are the ones
# heat_tpu's programs compute, bit for bit
_RCP = {k: float(np.float32(1.0) / np.float32(v)) for k, v in QMAX.items()}

_VALID_MODES = ("on", "off", "int8", "fp8")
_MODE_OVERRIDE: "list[Optional[str]]" = [None]

_WIRE_MIN_BYTES_DEFAULT = 64 << 10  # below this a transfer is latency-bound


def qdtype(mode_str: str) -> torch.dtype:
    """The torch dtype of one wire or quantization mode (``int8`` |
    ``fp8``)."""
    if mode_str == "int8":
        return torch.int8
    if mode_str == "fp8":
        f8 = getattr(torch, "float8_e4m3fn", None)
        if f8 is None:
            raise ValueError("fp8 quantization needs a torch with float8_e4m3fn support")
        return f8
    raise ValueError(f"quantize dtype must be 'int8' or 'fp8', got {mode_str!r}")


def fp8_available() -> bool:
    return getattr(torch, "float8_e4m3fn", None) is not None


def mode(env: Optional[dict] = None) -> str:
    """The ``HEAT_TPU_WIRE`` mode: ``on`` (default), ``off``, or a forced
    ``int8``/``fp8``.  A malformed value raises naming the variable."""
    if _MODE_OVERRIDE[0] is not None:
        return _MODE_OVERRIDE[0]
    raw = (os.environ if env is None else env).get("HEAT_TPU_WIRE", "on")
    raw = raw.strip().lower() or "on"
    if raw not in _VALID_MODES:
        raise ValueError(f"HEAT_TPU_WIRE must be one of {_VALID_MODES}, got {raw!r}")
    return raw


def set_mode(mode_str: Optional[str]) -> Optional[str]:
    """Process-wide override of ``HEAT_TPU_WIRE`` (``None`` restores the
    environment variable).  Returns the previous override."""
    if mode_str is not None and mode_str not in _VALID_MODES:
        raise ValueError(f"mode must be one of {_VALID_MODES}, got {mode_str!r}")
    prev = _MODE_OVERRIDE[0]
    _MODE_OVERRIDE[0] = mode_str
    return prev


def min_bytes(env: Optional[dict] = None) -> int:
    """``HEAT_TPU_WIRE_MIN_BYTES`` (default 64 KiB): smaller transfers keep
    the f32 wire."""
    return autotune.env_bytes("HEAT_TPU_WIRE_MIN_BYTES", _WIRE_MIN_BYTES_DEFAULT, env)


_STATS = telemetry.register_group(
    "wire",
    {
        # dispatches that shipped a quantized format
        "quantized_dispatches": 0,
        # static declines while the plane was live
        "declined_static": 0,
        # explore rounds (every arm measured, the f32 result returned)
        "explores": 0,
        # bytes the f32 wire would have moved for quantized dispatches, and
        # what the quantized wire moved instead
        "bytes_logical": 0,
        "bytes_wire": 0,
        "by_arm": {"wire_f32": 0, "wire_int8": 0, "wire_fp8": 0},
    },
)


def stats() -> dict:
    """Snapshot of the ``wire`` counter group (Prometheus:
    ``heat_tpu_wire_*``)."""
    return telemetry.snapshot_group("wire")


# ---------------------------------------------------------------- grid math


def _reduce_axes(ndim: int, axes: tuple) -> tuple:
    return tuple(d for d in range(ndim) if d not in axes)


def _expand(scale: torch.Tensor, reduce_axes: tuple) -> torch.Tensor:
    for d in reduce_axes:
        scale = scale.unsqueeze(d)
    return scale


def scale_of(absmax: torch.Tensor, mode_str: str) -> torch.Tensor:
    """The f32 scales of f32 absmax values: ``absmax · f32(1/qmax)``, 1
    where the absmax is 0."""
    return torch.where(absmax > 0, absmax * _RCP[mode_str], torch.ones((), dtype=torch.float32, device=absmax.device))


def to_grid(x: torch.Tensor, scale_b: torch.Tensor, mode_str: str) -> torch.Tensor:
    """``x`` on the grid of the scales ``scale_b`` (broadcast against it):
    ``x / scale`` in f32, rounded half to even and clipped (int8) or
    clipped and cast (fp8)."""
    qmax = QMAX[mode_str]
    grid = x.to(torch.float32) / scale_b
    if mode_str == "int8":
        grid = torch.round(grid)
    return torch.clamp(grid, -qmax, qmax).to(qdtype(mode_str))


def absmax_encode(x: torch.Tensor, mode_str: str, axes: tuple):
    """``(q, scale)``: ``x`` on the ``mode_str`` grid with one f32 scale
    per index of the KEPT ``axes`` (``(0,)`` one scale a row, ``()`` one
    scalar for the whole block), reduced over every other axis.  All-zero
    rows get scale 1."""
    qdtype(mode_str)
    xf = x.to(torch.float32)
    reduce_axes = _reduce_axes(x.ndim, tuple(axes))
    absmax = torch.amax(xf.abs(), dim=reduce_axes) if reduce_axes else xf.abs()
    scale = scale_of(absmax, mode_str)
    return to_grid(xf, _expand(scale, reduce_axes), mode_str), scale


def absmax_decode(q: torch.Tensor, scale: torch.Tensor, axes: tuple, dtype) -> torch.Tensor:
    """A quantized block back in ``dtype``: ``q * scale`` in f32, the
    scale broadcast over the reduced axes."""
    sb = _expand(scale, _reduce_axes(q.ndim, tuple(axes)))
    return (q.to(torch.float32) * sb).to(dtype)


# ----------------------------------------------------------------- dispatch


def eligible(dtype, nbytes: int, *, exact: bool = False) -> bool:
    """Static eligibility of one transfer: a floating payload of at least
    ``HEAT_TPU_WIRE_MIN_BYTES`` wider than one byte, from a caller that did
    not ask for ``exact=True``, with the plane on.  An ineligible transfer
    takes the f32 wire with no table decision."""
    if exact:
        return _note_declined()
    if mode() == "off":
        return False
    dt = dtype if isinstance(dtype, torch.dtype) else dtype.torch_type()
    if not dt.is_floating_point:
        return _note_declined()
    if dt.itemsize <= 1:
        return _note_declined()
    if int(nbytes) < min_bytes():
        return _note_declined()
    return True


def _note_declined() -> bool:
    _STATS["declined_static"] += 1
    return False


def decline(site: str) -> None:
    """Count one consult of a site that is never eligible (``tiled_take``:
    its payload is the data itself)."""
    if mode() != "off":
        _STATS["declined_static"] += 1


def choose(site: str, geometry: tuple, desc: str = "", links: bool = True):
    """The wire-arm consult of one eligible transfer: ``(arm,
    decision_or_None)``.  A forced mode returns its arm with no decision;
    the tuning plane off, or ``links=False`` (the transfer's positions
    share one device), means ``wire_f32``; otherwise the table decides and
    the caller runs :func:`explore` when ``decision.explore`` is set."""
    m = mode()
    if m in ("int8", "fp8"):
        if m == "fp8" and not fp8_available():
            return "wire_f32", None
        return "wire_" + m, None
    if not links or not autotune.enabled():
        return "wire_f32", None
    key = autotune.wire_key(site, *geometry)
    d = autotune.decide(key, "wire_f32", desc=desc or f"wire {site} {geometry}", arms=autotune.WIRE_ARMS)
    return d.arm, d


def consume(site: str, geometry: tuple, links: bool = True) -> str:
    """The consume-only consult for sites that must not run their transfer
    twice: a forced mode applies; otherwise (``links`` as in :func:`choose`)
    only a resolved winner of the shared key is served, and an unresolved
    key records the f32 prior.  Returns the wire mode (``""`` | ``"int8"``
    | ``"fp8"``)."""
    m = mode()
    if m in ("int8", "fp8"):
        if m == "fp8" and not fp8_available():
            return ""
        return m
    if not links or not autotune.enabled():
        return ""
    key = autotune.wire_key(site, *geometry)
    w = autotune.winner(key)
    if w in ("wire_int8", "wire_fp8"):
        return w[len("wire_"):]
    if w is None:
        autotune.note_prior(key, "wire_f32", site=f"wire_{site}")
    return ""


def explore(decision, run_for):
    """One explore round: ``run_for(wire_mode)`` with ``""`` (f32),
    ``"int8"`` and ``"fp8"`` under measurement; returns the f32 result.
    Only a missing fp8 dtype forfeits its arm (an infinite time); an arm
    that raises raises."""
    out, f32_s = autotune.timed(run_for, "")
    autotune.observe(decision.key, "wire_f32", f32_s)
    for arm, wm in (("wire_int8", "int8"), ("wire_fp8", "fp8")):
        if wm == "fp8" and not fp8_available():
            dur = float("inf")
        else:
            _, dur = autotune.timed(run_for, wm)
        autotune.observe(decision.key, arm, dur)
    _STATS["explores"] += 1
    _STATS["by_arm"]["wire_f32"] += 1
    return out


def payload_nbytes(n_elems: int, n_scales: int, mode_str: str) -> int:
    """On-wire bytes of one quantized transfer: 1-byte elements plus the
    f32 scales beside them."""
    return int(n_elems) * 1 + int(n_scales) * 4


def account(site: str, arm: str, logical_bytes: int, wire_bytes: int) -> None:
    """Ledger one quantized dispatch: the f32 bytes the wire would have
    moved against what the quantized format moved."""
    _STATS["quantized_dispatches"] += 1
    _STATS["by_arm"][arm] += 1
    _STATS["bytes_logical"] += int(logical_bytes)
    _STATS["bytes_wire"] += int(wire_bytes)
    telemetry.record_event("wire_dispatch", site=site, arm=arm, logical_bytes=int(logical_bytes),
                           wire_bytes=int(wire_bytes))
