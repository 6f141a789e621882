"""Benchmark monitoring harness (counterpart of heat_tpu/utils/monitor.py).

An ``@monitor()`` decorator records each call's wall time and device memory,
:func:`record` a measurement timed elsewhere (a chain-delta slope), and
:func:`profile_trace` captures a ``torch.profiler`` trace (CPU and, on the
card, CUDA activity) of a block as a Chrome trace file that Perfetto opens.
Each measurement is one JSON line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core import memtrack, telemetry

__all__ = ["monitor", "measurements", "record", "report", "reset", "profile_trace"]

_MEASUREMENTS: List[Dict[str, Any]] = []


def _device_memory() -> Optional[int]:
    """The most bytes in use on any card (``None`` on the CPU):
    :func:`memtrack.device_bytes_in_use`."""
    _per, worst = memtrack.device_bytes_in_use()
    return worst


def _drain() -> None:
    """Wait for the card, so the clock covers the work a call queued."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # ht: HT002 ok — benchmark drain: the sync is the measurement barrier


def monitor(name: Optional[str] = None, emit: bool = True) -> Callable:
    """Decorator: measure each call's wall time and device memory delta.
    One JSON line per call goes to stderr (stdout stays machine-parsable)
    and into :func:`measurements`."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            mem0 = _device_memory()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except Exception as err:
                # the failed call is a measurement too: how long it ran and
                # that it died, then the error goes on
                wall = time.perf_counter() - t0
                entry = {"name": label, "wall_s": round(wall, 6), "status": "error", "error": type(err).__name__}
                _MEASUREMENTS.append(entry)
                telemetry.record_event("measurement", name=label, wall_s=entry["wall_s"], status="error",
                                       error=type(err).__name__)
                if emit:
                    print(json.dumps(entry), file=sys.stderr)
                raise
            _drain()
            wall = time.perf_counter() - t0
            mem1 = _device_memory()
            entry = {"name": label, "wall_s": round(wall, 6)}
            if mem1 is not None:
                entry["device_bytes_in_use"] = mem1
                if mem0 is not None:
                    entry["device_bytes_delta"] = mem1 - mem0
            _MEASUREMENTS.append(entry)
            telemetry.record_event("measurement", name=label, wall_s=entry["wall_s"])
            if emit:
                print(json.dumps(entry), file=sys.stderr)
            return out

        return wrapper

    return deco


def record(name: str, wall_s: float, emit: bool = True, **fields) -> None:
    """Record a measurement timed elsewhere, e.g. a chain-delta slope;
    ``fields`` say how (``method=``, ``k1=``, ...)."""
    entry = {"name": name, "wall_s": round(float(wall_s), 6), **fields}
    mem = _device_memory()
    if mem is not None:
        entry["device_bytes_in_use"] = mem
    _MEASUREMENTS.append(entry)
    if emit:
        print(json.dumps(entry), file=sys.stderr)


def measurements() -> List[Dict[str, Any]]:
    """Every measurement recorded since the last :func:`reset`."""
    return list(_MEASUREMENTS)


def annotate_last(**fields) -> None:
    """Attach fields to the most recent measurement (e.g. the iterations a
    workload actually ran)."""
    if not _MEASUREMENTS:
        raise RuntimeError("no measurement to annotate")
    _MEASUREMENTS[-1].update(fields)


def report(file=None) -> None:
    """Write every measurement as one JSON line (default: stderr)."""
    out = file or sys.stderr
    for entry in _MEASUREMENTS:
        print(json.dumps(entry), file=out)


def reset() -> None:
    _MEASUREMENTS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` as ``heat_tpu_torch.<pid>.<ms>.trace.json`` (Chrome trace
    format; open with Perfetto).  CUDA activity is traced where a card is
    present; the trace is written after the card has finished the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        _drain()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"heat_tpu_torch.{os.getpid()}.{int(time.time() * 1e3)}.trace.json"))
