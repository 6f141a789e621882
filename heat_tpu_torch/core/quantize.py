"""Weight quantization for inference (counterpart of
heat_tpu/core/quantize.py).

* :func:`quantize_weights` gives a :class:`QuantizedDNDarray`: an int8 (or
  fp8 ``e4m3``) copy of a weight DNDarray, one shard a position as the
  master's, with absmax-per-channel f32 scales beside it, both in the
  memtrack ledger.  ``donate=True`` tags the master's shards ``donated``
  and poisons them for the sanitizer (a callee cannot free a tensor its
  caller holds: the owner drops its reference, as
  ``KNeighborsClassifier.quantize_`` does).
* :func:`matmul_quantized` / :func:`linear`: the quantized product behind
  ``linalg.matmul`` and ``nn.functional.linear``, dispatched over the arms
  :data:`~heat_tpu_torch.core.autotune.QUANT_ARMS` per (site, geometry,
  device kind).  ``bf16`` dequantizes and runs the ordinary matmul: the
  reference arm, whose result an explore call returns bitwise and which
  ``HEAT_TPU_AUTOTUNE=off`` restores.  ``int8`` multiplies by the
  low-precision operand widened to the f32 accumulator and scales the
  product per channel.  It goes ring-first, as heat_tpu's: the overlap
  engine's ``matmul_raw`` with the scale and the cast in its
  :class:`~heat_tpu_torch.parallel.overlap.Epilogue`, the int8 block
  widened in the ring's step; where the ring declines, heat_tpu's
  ``_gspmd_quant_mm`` form runs in one ``torch.matmul``.
* :func:`quantize_tensor` / :func:`quantize_params`: the raw-tensor tier
  for the MoE FFN; :class:`QuantizedTensor` is a frozen dataclass.

Under autograd (grad mode on and an input that requires grad, the port's
counterpart of heat_tpu's traced operand) a site takes the bf16 arm with
no timing and no table write: :func:`declines_to_reference`.  An int8 arm
that raises raises; heat_tpu's bf16 rescue is not ported, so
``int8_fallbacks`` stays 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from . import autotune, memtrack, telemetry, types, wire as _wire
from .dndarray import DNDarray, _wrap
from ..analysis import sanitize

__all__ = [
    "QuantizedDNDarray",
    "QuantizedTensor",
    "declines_to_reference",
    "dequantize_tensor",
    "linear",
    "matmul_quantized",
    "quantize_params",
    "quantize_tensor",
    "quantize_weights",
    "stats",
    "tuned_arm",
]

_qdtype = _wire.qdtype

_STATS = telemetry.register_group(
    "quantize",
    {
        "quantized": 0,       # quantize_weights / quantize_tensor calls
        "donated": 0,         # masters donated
        "dequantized": 0,     # whole-weight dequantizations (the bf16 arm's cost)
        "matmuls": 0,         # matmul_quantized entries
        "by_arm": {"bf16": 0, "int8": 0},
        "declines": 0,        # declines straight to bf16 (autograd, plane off)
        "int8_fallbacks": 0,  # heat_tpu's bf16 rescue of a failing int8 arm; 0 here
    },
)


def stats() -> dict:
    """Snapshot of the ``quantize`` counter group (Prometheus:
    ``heat_tpu_quantize_*``)."""
    return telemetry.snapshot_group("quantize")


def declines_to_reference(*tensors) -> bool:
    """The autograd rule: the bf16 arm, untimed and with no table write,
    whenever grad mode is on and an input requires grad (heat_tpu's rule
    for a traced operand)."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


# ------------------------------------------------------------ raw-tensor tier


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized tensor: ``q`` (int8/fp8), the f32 ``scale`` with one
    entry per index of the kept ``axes``, and the master's dtype name
    (``"float32"``) for the round trip."""

    q: Any
    scale: Any
    axes: Tuple[int, ...]
    orig_dtype: str

    @property
    def shape(self) -> tuple:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() * self.q.element_size()) + int(self.scale.numel() * self.scale.element_size())

    def scale_broadcast(self) -> torch.Tensor:
        """The scale shaped to broadcast against ``q``."""
        return _wire._expand(self.scale, _wire._reduce_axes(self.q.ndim, self.axes))


def _norm_axes(axis, ndim: int) -> Tuple[int, ...]:
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(sorted(a % ndim for a in axes))


def quantize_tensor(w, dtype: str = "int8", *, axis=-1) -> QuantizedTensor:
    """Quantize one tensor with absmax scales per channel along ``axis``,
    an int or a tuple of kept axes (the MoE expert weights ``(E, d, h)`` /
    ``(E, h, d)`` take ``axis=(0, 2)``: per-(expert, out-channel))."""
    _qdtype(dtype)
    w = torch.as_tensor(w)
    axes = _norm_axes(axis, w.ndim)
    q, scale = _wire.absmax_encode(w, dtype, axes)
    memtrack.register_buffer(q, tag="leaf")
    memtrack.register_buffer(scale, tag="leaf")
    _STATS["quantized"] += 1
    return QuantizedTensor(q, scale, axes, autotune.dtype_name(w.dtype))


def dequantize_tensor(qt: QuantizedTensor) -> torch.Tensor:
    """A :class:`QuantizedTensor` back in its master dtype."""
    _STATS["dequantized"] += 1
    out = qt.q.to(torch.float32) * qt.scale_broadcast()
    return out.to(getattr(torch, qt.orig_dtype))


def quantize_params(params, dtype: str = "int8", *, targets: Tuple[str, ...] = ("w_in", "w_out"), axis=(0, 2)):
    """Walk a nested parameter dict and replace every tensor leaf whose key
    is in ``targets`` by a :class:`QuantizedTensor`.  Returns a new tree;
    other leaves are shared, not copied.  The quantized tree feeds
    :func:`~heat_tpu_torch.parallel.expert.moe_ffn` directly."""
    if not isinstance(params, dict):
        return params
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = quantize_params(val, dtype, targets=targets, axis=axis)
        elif key in targets and hasattr(val, "ndim"):
            out[key] = quantize_tensor(val, dtype, axis=axis)
        else:
            out[key] = val
    return out


# ----------------------------------------------------------- DNDarray tier


def _distinct(shards):
    seen, out = set(), []
    for s in shards:
        if id(s) not in seen:
            seen.add(id(s))
            out.append(s)
    return out


class QuantizedDNDarray:
    """A per-channel-scaled low-precision weight with DNDarray metadata
    (gshape, split, device, comm), not a DNDarray: only the quantized
    consumers (``matmul_quantized``, ``cdist_quantized``) and
    :meth:`dequantize` take it.  ``qshards`` holds one int8/fp8 tensor a
    position, cut as the master was; ``scale`` is the whole f32
    ``(gshape[axis],)`` table, on every position's device."""

    __slots__ = ("qshards", "scale", "axis", "orig_dtype", "gshape", "split", "device", "comm")

    def __init__(self, qshards, scale, axis, orig_dtype, gshape, split, device, comm):
        self.qshards = list(qshards)
        self.scale = scale
        self.axis = int(axis)
        self.orig_dtype = orig_dtype  # the master's heat type
        self.gshape = tuple(gshape)
        self.split = split
        self.device = device
        self.comm = comm

    @property
    def q(self) -> torch.Tensor:
        """The whole low-precision tensor (a gather for a split array,
        through the exchange on a comm that spans processes)."""
        mine = self.comm.local_shards(self.qshards)
        if self.split is None or len(self.qshards) == 1:
            return mine[0]
        if self.comm.spans_processes:
            from ..parallel import collectives

            return collectives.all_gather(mine, dim=self.split, comm=self.comm)[0]
        return torch.cat(self.qshards, dim=self.split)

    @property
    def shape(self) -> tuple:
        return self.gshape

    @property
    def ndim(self) -> int:
        return len(self.gshape)

    @property
    def dtype(self):
        """The master's heat type: what consumers compute in and return."""
        return self.orig_dtype

    @property
    def qdtype(self) -> str:
        return autotune.dtype_name(self.qshards[0].dtype)

    @property
    def nbytes(self) -> int:
        """This process's bytes: its positions' shards and the scale."""
        q = sum(int(s.numel() * s.element_size()) for s in _distinct(self.comm.local_shards(self.qshards)))
        return q + int(self.scale.numel() * self.scale.element_size())

    def __repr__(self) -> str:
        return (
            f"QuantizedDNDarray(shape={self.gshape}, q={self.qdtype}, "
            f"channel_axis={self.axis}, split={self.split}, "
            f"master={self.orig_dtype.__name__})"
        )

    def _scale_for(self, r: int, shard: torch.Tensor) -> torch.Tensor:
        """Position ``r``'s slice of the scale, shaped to broadcast against
        its shard."""
        s = self.scale.to(shard.device)
        if self.split == self.axis:
            off, lshape, _ = self.comm.chunk(self.gshape, self.split, rank=r)
            s = s.narrow(0, off, lshape[self.axis])
        return _wire._expand(s, tuple(d for d in range(self.ndim) if d != self.axis))

    def dequantize(self) -> DNDarray:
        """Back to a master-dtype DNDarray, split as the master was (the
        bf16 arm's operand)."""
        _STATS["dequantized"] += 1
        tt = self.orig_dtype.torch_type()
        done = {}

        def one(r):
            s = self.qshards[r]
            if id(s) not in done:
                done[id(s)] = (s.to(torch.float32) * self._scale_for(r, s)).to(tt)
            return done[id(s)]

        shards = self.comm.per_position(one, self.gshape, self.split)
        return DNDarray(shards, self.gshape, self.orig_dtype, self.split, self.device, self.comm)

    def transpose(self) -> "QuantizedDNDarray":
        """2-D transpose: the channel axis and the split follow (the
        ``(out, in)`` to ``(in, out)`` hop of ``F.linear``)."""
        if self.ndim != 2:
            raise ValueError("QuantizedDNDarray.transpose is 2-D only")
        split = None if self.split is None else 1 - self.split
        gshape = (self.gshape[1], self.gshape[0])
        return QuantizedDNDarray(
            self.comm.per_position(lambda r: self.qshards[r].T, gshape, split), self.scale, 1 - self.axis,
            self.orig_dtype, gshape, split, self.device, self.comm,
        )

    @property
    def T(self) -> "QuantizedDNDarray":
        return self.transpose()


def _global_scale(shards: List[torch.Tensor], split, axis: int, ndim: int, mode: str, comm=None) -> torch.Tensor:
    """The f32 per-channel scale of a split weight: each shard's absmax
    over every axis but ``axis``, joined along the channels when the split
    cuts them, else the maximum over the positions (max is exact, so the
    scale is the whole array's bit for bit).  On a ``comm`` that spans
    processes ``shards`` are this process's positions' and the joined or
    maximised table crosses to every process."""
    from ..parallel import collectives

    across = comm is not None and comm.spans_processes and split is not None
    reduce_axes = tuple(d for d in range(ndim) if d != axis)

    def absmax_of(s):
        return torch.amax(s.to(torch.float32).abs(), dim=reduce_axes) if reduce_axes else s.to(torch.float32).abs()

    if across and split == axis:
        return _wire.scale_of(collectives.all_gather([absmax_of(s) for s in shards], dim=0, comm=comm)[0], mode)
    parts = [absmax_of(s) for s in _distinct(shards) if s.numel() or split == axis]
    if split == axis:
        absmax = torch.cat([p.to(parts[0].device) for p in parts])
    else:
        absmax = parts[0]
        for p in parts[1:]:
            absmax = torch.maximum(absmax, p.to(absmax.device))
        if across:
            absmax = collectives.pmax([absmax], comm=comm)[0]
    return _wire.scale_of(absmax, mode)


def quantize_weights(w: DNDarray, dtype: str = "int8", *, axis: int = 0, donate: bool = False) -> QuantizedDNDarray:
    """Quantize a weight DNDarray to int8/fp8 with absmax scales per
    ``axis`` channel (default 0: torch's ``(out_features, in_features)``
    convention).  The quantized shards and the scales are ledgered in
    memtrack, so the residency shows in ``live_buffers()`` and
    ``census()["bytes_by_dtype"]``.

    ``donate=True`` tags the master's shards ``donated`` in memtrack and
    poisons them: under ``HEAT_TPU_SANITIZE=1`` a transport entry that reads
    them again raises ``UseAfterDonateError``.  The caller drops its own
    reference."""
    from . import sanitation

    sanitation.sanitize_in(w)
    _qdtype(dtype)
    axis = axis % w.ndim
    master = w.comm.local_shards(w.shards)
    scale = _global_scale(master, w.split, axis, w.ndim, dtype, w.comm)
    sharded = QuantizedDNDarray([], scale, axis, w.dtype, w.shape, w.split, w.device, w.comm)
    done = {}

    def one(r):
        s = w.shards[r]
        if id(s) not in done:
            done[id(s)] = _wire.to_grid(s, sharded._scale_for(r, s), dtype)
        return done[id(s)]

    qshards = w.comm.per_position(one, w.shape, w.split)
    sharded.qshards = qshards
    memtrack.register_shards(w.comm.local_shards(qshards), tag="leaf", split=w.split)
    memtrack.register_buffer(scale, tag="leaf")
    _STATS["quantized"] += 1
    if donate:
        _STATS["donated"] += 1
        memtrack.tag_shards(master, "donated")
        for s in _distinct(master):
            sanitize.poison(s, donated_site="quantize.quantize_weights(donate=True)")
    telemetry.record_event(
        "quantize", dtype=autotune.dtype_name(qshards[w.comm.local_positions[0]].dtype), shape=tuple(w.shape), axis=axis, donate=bool(donate),
        master_nbytes=int(w.nbytes), quant_nbytes=int(sharded.nbytes),
    )
    return sharded


# ------------------------------------------------------------ arm dispatch


def tuned_arm(site: str, geometry: tuple, bf16_fn: Callable[[], Any], int8_fn: Callable[[], Any], *,
              desc: str = "", arm: Optional[str] = None, comm=None, device=None):
    """The quantized-arm dispatch: per (site, geometry, device kind) an
    explore call runs both arms under measurement and returns the bf16
    (reference) result; a resolved winner runs alone; the tuning plane off
    means bf16 with no table decision.  ``arm`` forces one arm.  An arm
    that raises raises.  On a ``comm`` that spans processes the decision
    is agreed across them (``transport.agreed_decision``): the arms move
    different bytes."""
    if arm is not None:
        if arm not in autotune.QUANT_ARMS:
            raise ValueError(f"arm must be one of {autotune.QUANT_ARMS}")
        _STATS["by_arm"][arm] += 1
        return int8_fn() if arm == "int8" else bf16_fn()
    if not autotune.enabled():
        _STATS["declines"] += 1
        _STATS["by_arm"]["bf16"] += 1
        return bf16_fn()
    from ..parallel import transport

    key = autotune.quant_key(site, *geometry)
    decision = transport.agreed_decision(
        key, lambda: autotune.decide(key, "bf16", desc=desc or f"{site} {geometry}", arms=autotune.QUANT_ARMS),
        autotune.QUANT_ARMS, comm, device)
    if decision.explore:
        out, bf16_s = autotune.timed(bf16_fn)
        autotune.observe(key, "bf16", bf16_s)
        _, int8_s = autotune.timed(int8_fn)
        autotune.observe(key, "int8", int8_s)
        _STATS["by_arm"]["bf16"] += 1
        return out
    _STATS["by_arm"][decision.arm] += 1
    return int8_fn() if decision.arm == "int8" else bf16_fn()


# ------------------------------------------------------------- matmul tier


def _quant_mm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, comp: torch.dtype, out_dt: torch.dtype):
    """The int8 arm's product (heat_tpu's ``_gspmd_quant_mm``): the
    low-precision operand widened to the accumulator dtype, the product
    scaled per output column, then cast."""
    out = torch.matmul(x.to(comp), q.to(comp))
    return (out * scale.to(device=out.device, dtype=comp)).to(out_dt)


def matmul_quantized(x: DNDarray, qw: QuantizedDNDarray, out_split="auto", *, arm: Optional[str] = None) -> DNDarray:
    """``x @ qw`` for a 2-D quantized right operand whose channel axis is
    the output (column) axis, dispatched over the quantized arms (see the
    module docstring).  ``arm`` forces one."""
    if qw.ndim != 2 or x.ndim != 2:
        raise ValueError(f"matmul_quantized is 2-D only, got {x.shape} @ {qw.shape}")
    if qw.axis != 1:
        raise ValueError(
            "matmul_quantized needs the channel axis on the output "
            "(column) axis of the right operand — transpose the "
            f"QuantizedDNDarray first (channel axis is {qw.axis})"
        )
    m, k = x.shape
    k2, n = qw.shape
    if k != k2:
        raise ValueError(f"matmul_quantized: inner dimensions do not match: {x.shape} @ {qw.shape}")
    _STATS["matmuls"] += 1
    if out_split == "auto":
        out_split = 0 if x.split == 0 else (1 if qw.split == 1 else None)
    out_ht = types.promote_types(x.dtype, qw.orig_dtype)
    out_dt = out_ht.torch_type()
    comp = torch.promote_types(x.dtype.torch_type(), torch.float32)

    def _bf16() -> DNDarray:
        from .linalg import basics

        return basics.matmul(x, qw.dequantize())

    def _int8() -> DNDarray:
        from ..parallel import overlap as _overlap

        comm = x.comm
        ep = _overlap.Epilogue(scale=qw.scale, dtype=out_dt)
        ring = _overlap.matmul_raw(comm, x.shards, qw.qshards, (m, k), (k, n), x.split, qw.split, out_split,
                                   comp_dtype=comp, epilogue=ep)
        if ring is not None:
            return DNDarray(ring, (m, n), out_ht, out_split, x.device, comm)
        if out_split == 0 and x.split == 0:
            qf = qw.q
            shards = comm.per_position(lambda r: _quant_mm(x.shards[r], qf.to(x.shards[r].device), qw.scale, comp,
                                                           out_dt), (m, n), 0)
            return DNDarray(shards, (m, n), out_ht, 0, x.device, comm)
        if out_split == 1 and qw.split == 1 and x.split != 0:
            xf = x.larray
            shards = comm.per_position(lambda r: _quant_mm(xf, qw.qshards[r], qw._scale_for(r, qw.qshards[r]).reshape(-1),
                                                           comp, out_dt), (m, n), 1)
            return DNDarray(shards, (m, n), out_ht, 1, x.device, comm)
        out = _quant_mm(x.larray, qw.q.to(x.larray.device), qw.scale, comp, out_dt)
        return _wrap(out, out_split, x.device, comm)

    if arm is None and declines_to_reference(*x.comm.local_shards(x.shards)):
        _STATS["declines"] += 1
        return _bf16()
    geometry = (m, k, n, x.comm.size, autotune.dtype_name(comp), x.split, qw.split, out_split, qw.qdtype)
    return tuned_arm("linear", geometry, _bf16, _int8, desc=f"linear {m}x{k}x{n} {qw.qdtype} S={x.comm.size}",
                     arm=arm, comm=x.comm, device=x.comm.local_shards(x.shards)[0].device)


def linear(x: DNDarray, qw: QuantizedDNDarray, bias=None) -> DNDarray:
    """Quantized ``F.linear``: ``x @ qw.T + bias`` with ``qw`` in torch's
    ``(out_features, in_features)`` layout (channel axis 0)."""
    if qw.ndim != 2 or qw.axis != 0:
        raise ValueError(
            "linear expects a (out_features, in_features) quantized "
            f"weight with channel axis 0, got shape {qw.shape} axis {qw.axis}"
        )
    out = matmul_quantized(x, qw.transpose())
    if bias is not None:
        out = out + bias
    return out
