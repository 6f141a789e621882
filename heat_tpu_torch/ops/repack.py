"""Rechunk repack, K7 of the port (counterpart of heat_tpu/ops/repack.py,
whose Pallas kernel ``_repack_kernel`` this replaces).

On the TPU the kernel wrote a narrow-minor reshape without the 128-lane
padding.  On the card there is no lane padding, so what the kernel
computes is the transport engine's rechunk output itself: one destination
shard of a split-crossing reshape, assembled from the source intervals that
cover it and written in its final shape, bit for bit.

:func:`repack_segments` lays ``(src, start, length)`` segments of contiguous
1-D tensors end to end and returns them as a new contiguous tensor of
``shape_out``, or writes them into ``out=``, a contiguous tensor such as a
row range of a shard (the assignment routes of ``DNDarray.__setitem__``);
:func:`repack` is the one-segment case, the JAX signature.
For tensors on the card they launch the hand-written CUDA kernel in
``csrc/repack.cu`` (a raw byte copy, so every dtype is exact); for tensors
on the CPU they compute :func:`reference_repack_segments`, ``torch.cat``
then ``reshape``.  There is no fallback between the two: a CUDA input the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["reference_repack", "reference_repack_segments", "repack", "repack_segments"]

#: kernel launches so far; :func:`repack_segments` adds one per launch and nowhere else
launches = 0
#: calls of :func:`repack_segments` (and so of :func:`repack`) on any device
calls = 0

#: the kernel's segment table holds at most this many segments; a rechunk
#: destination takes at most 1 + 4 (one per ring shift of the plan)
MAX_SEGMENTS = 8

_SOURCES = ("repack.cu",)
_fn = None

Segment = Tuple[torch.Tensor, int, int]


def _shape(shape_out) -> Tuple[int, ...]:
    return tuple(int(d) for d in shape_out)


def reference_repack_segments(segments: Sequence[Segment], shape_out, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``torch.cat`` of the segments, then
    ``.reshape(shape_out).clone()``; with ``out``, each segment copied into
    its place there."""
    shape_out = _shape(shape_out)
    parts = [src.narrow(0, int(start), int(length)) for src, start, length in segments]
    if not parts:
        raise ValueError("repack needs at least one segment")
    if out is None:
        return torch.cat(parts).reshape(shape_out).clone()
    flat, at = out.view(-1), 0
    for p in parts:
        flat.narrow(0, at, p.numel()).copy_(p)
        at += p.numel()
    return out


def reference_repack(flat: torch.Tensor, shape_out) -> torch.Tensor:
    """The plain version of :func:`repack`: ``flat.reshape(shape_out).clone()``."""
    return flat.reshape(_shape(shape_out)).clone()


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_repack", _SOURCES).heat_repack_segments
        i64p = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i64p, i64p, i64p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_out(out: torch.Tensor, segments: Sequence[Segment], shape_out: Tuple[int, ...]):
    if not out.is_contiguous():
        raise ValueError("repack's out must be contiguous")
    if out.dtype != segments[0][0].dtype or tuple(out.shape) != shape_out:
        raise ValueError(f"repack's out is {out.dtype} {tuple(out.shape)}, the segments fill {segments[0][0].dtype} {shape_out}")


def _check(segments: Sequence[Segment], shape_out: Tuple[int, ...]):
    if not segments:
        raise ValueError("repack needs at least one segment")
    dtype = segments[0][0].dtype
    total = 0
    for src, start, length in segments:
        if not isinstance(src, torch.Tensor) or src.ndim != 1:
            raise ValueError(f"a repack segment's source must be a 1-D tensor, got {getattr(src, 'shape', type(src))}")
        if not src.is_contiguous():
            raise ValueError("a repack segment's source must be contiguous")
        if src.dtype != dtype:
            raise TypeError(f"repack segments must share one dtype, got {dtype} and {src.dtype}")
        start, length = int(start), int(length)
        if start < 0 or length < 0 or start + length > src.numel():
            raise ValueError(f"segment [{start}, {start + length}) lies outside a source of {src.numel()} elements")
        total += length
    if total != math.prod(shape_out):
        raise ValueError(f"segments of {total} elements cannot fill shape {shape_out}")


def repack_segments(segments: Sequence[Segment], shape_out, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The segments ``(src, start, length)`` (contiguous 1-D tensors of one
    dtype, on one device) laid end to end, as a new contiguous tensor of
    ``shape_out``, bit for bit, or written into ``out`` (contiguous, of
    that shape and dtype, on that device; it must not overlap a source),
    which is returned.

    On the card: one launch, at most :data:`MAX_SEGMENTS` non-empty
    segments; zero-length segments are dropped and a zero-element result
    returns without a launch."""
    global launches, calls
    shape_out = _shape(shape_out)
    _check(segments, shape_out)
    if out is not None:
        _check_out(out, segments, shape_out)
    calls += 1
    if all(src.device.type == "cpu" for src, _, _ in segments) and (out is None or out.device.type == "cpu"):
        return reference_repack_segments(segments, shape_out, out)
    dev = segments[0][0].device
    if dev.type != "cuda" or any(src.device != dev for src, _, _ in segments) or (out is not None and out.device != dev):
        raise ValueError(f"repack needs its segments on one CUDA device, got {sorted({str(s.device) for s, _, _ in segments})}")
    live = [(src, int(start), int(length)) for src, start, length in segments if int(length) > 0]
    if len(live) > MAX_SEGMENTS:
        raise ValueError(f"the repack kernel takes at most {MAX_SEGMENTS} segments, got {len(live)}")
    if out is None:
        out = torch.empty(shape_out, dtype=segments[0][0].dtype, device=dev)
    if not live:
        return out
    item = out.element_size()
    n = len(live)
    srcs = (ctypes.c_void_p * n)(*[src.data_ptr() for src, _, _ in live])
    src_off = (ctypes.c_longlong * n)(*[start * item for _, start, _ in live])
    dst_off = []
    pos = 0
    for _, _, length in live:
        dst_off.append(pos * item)
        pos += length
    dst_off = (ctypes.c_longlong * n)(*dst_off)
    lens = (ctypes.c_longlong * n)(*[length * item for _, _, length in live])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(srcs, src_off, dst_off, lens, n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"repack kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


def repack(flat: torch.Tensor, shape_out) -> torch.Tensor:
    """``flat.reshape(shape_out)`` as a new contiguous tensor, bit for bit
    (heat_tpu/ops/repack.py:114); ``flat`` is contiguous and holds exactly
    ``prod(shape_out)`` elements."""
    if not flat.is_contiguous():
        raise ValueError("repack takes a contiguous tensor")
    flat = flat.view(-1)
    return repack_segments([(flat, 0, flat.numel())], shape_out)
