"""Device-memory ledger: per-buffer attribution, readings of the card's
allocator, retention checks (counterpart of heat_tpu/core/memtrack.py).

**Live-buffer ledger.**  The factories, the DNDarray, the DCSR matrix, the
sparse product's staging and the transport engine's outputs register
their tensors here (:func:`register_buffer`): bytes, dtype, shape, split,
device, a tag (``leaf|pinned|staging|donated|output``) and the creation
site (the first frame outside the package, :func:`guard.capture_site`).
An entry dies with its tensor (a ``weakref`` callback).
:func:`live_buffers` answers "who holds device memory now" largest first,
:func:`census` packages it for a postmortem, and the ``memtrack`` group in
``telemetry.snapshot()`` carries the summary.

**Device readers.**  :func:`device_bytes_in_use` and
:func:`min_free_bytes` read the caching allocator through
``torch.cuda.memory_stats`` (``allocated_bytes.all.current``) and
``torch.cuda.mem_get_info``: host-side counters, no device
synchronisation.  The CPU has no reader and reports ``None``.
:func:`stats_override` simulates a card's readings for tests.

**Sampling.**  :func:`sample_bytes` reads the worst device's bytes in use
(falling back to the ledger's live bytes where no device reports; the
source rides the sample); ``telemetry.timed_call`` samples around its
timed calls.

**Retention.**  :func:`memwatch` scopes a region whose registrations
should die by its exit; survivors surface through :func:`leaks`.

Gating: the ledger registers at ``events`` level and above
(``HEAT_TPU_MEMTRACK=0`` silences it there too); below, a would-be
registration is one integer compare.
"""

from __future__ import annotations

import gc
import os
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import guard, telemetry

__all__ = [
    "census",
    "device_bytes_in_use",
    "device_peaks",
    "enabled",
    "leaks",
    "live_buffers",
    "memwatch",
    "min_free_bytes",
    "register_buffer",
    "register_shards",
    "reset",
    "sample_bytes",
    "set_enabled",
    "set_stats_override",
    "stats_override",
    "suggest_budget",
    "summary",
    "tag_buffer",
    "tag_shards",
    "would_fit",
]

# the tag vocabulary: why a buffer is (still) resident
TAGS = ("leaf", "pinned", "staging", "donated", "output")

# switch under the telemetry level: HEAT_TPU_MEMTRACK=0 keeps the flight
# recorder, spans and timings at events level but silences the ledger and
# the sampler
_ENABLED = [os.environ.get("HEAT_TPU_MEMTRACK", "1").lower()
            not in ("0", "off", "false")]


def set_enabled(on: bool) -> bool:
    """Enable/disable the ledger + sampler (returns the previous state).
    Orthogonal to the telemetry level: disabling keeps every other
    events-level facility live."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    return prev


def enabled() -> bool:
    return _ENABLED[0]

# id(buffer) -> record; the finalize on the buffer removes the entry, so
# the ledger holds no strong reference and can never extend a lifetime
_LEDGER: Dict[int, dict] = {}
_LIVE_BYTES = [0]       # sum of nbytes over _LEDGER (mutable module slot)
_PEAK_LIVE = [0]        # high-water mark of _LIVE_BYTES
_REG_SEQ = [0]          # registration counter (memwatch scope marker)
_DEVICE_PEAKS: Dict[str, int] = {}   # device str -> max sampled bytes_in_use
_WATCH_RETAINED: List[dict] = []     # survivors of the last memwatch() scope
# per-tag live bytes and their high-water marks, kept incrementally
# (register/retag/drop): a scan of _LEDGER sees only the tags of now, and
# the peak "staging" residency needs the history
_LIVE_BY_TAG: Dict[str, int] = {}
_PEAK_BY_TAG: Dict[str, int] = {}


def _reset_state() -> None:
    _LEDGER.clear()
    _LIVE_BYTES[0] = 0
    _PEAK_LIVE[0] = 0
    _REG_SEQ[0] = 0
    _DEVICE_PEAKS.clear()
    _WATCH_RETAINED.clear()
    _LIVE_BY_TAG.clear()
    _PEAK_BY_TAG.clear()


def _tag_add(tag: str, nbytes: int) -> None:
    live = _LIVE_BY_TAG.get(tag, 0) + nbytes
    _LIVE_BY_TAG[tag] = live
    if live > _PEAK_BY_TAG.get(tag, 0):
        _PEAK_BY_TAG[tag] = live


def summary() -> dict:
    """The ``memtrack`` group's derived fields: live count/bytes, the
    ledger high-water mark, a per-tag bytes breakdown, and the sampled
    per-device peaks."""
    by_tag: Dict[str, int] = {}
    by_dtype: Dict[str, int] = {}
    for rec in _LEDGER.values():
        by_tag[rec["tag"]] = by_tag.get(rec["tag"], 0) + rec["nbytes"]
        dt = str(rec["dtype"])
        by_dtype[dt] = by_dtype.get(dt, 0) + rec["nbytes"]
    return {
        "live_buffers": len(_LEDGER),
        "live_bytes": _LIVE_BYTES[0],
        "peak_live_bytes": _PEAK_LIVE[0],
        "bytes_by_tag": by_tag,
        "bytes_by_dtype": by_dtype,
        "peak_bytes_by_tag": dict(_PEAK_BY_TAG),
        "device_peak_bytes": dict(_DEVICE_PEAKS),
    }


_COUNTERS = telemetry.register_group(
    "memtrack",
    {
        # buffers ever registered / released by their finalizer
        "registered": 0,
        "released": 0,
        # re-registrations of an already-ledgered live buffer (a tensor
        # wrapped again, e.g. a shard shared by a view)
        "rebinds": 0,
        # watermark reads taken by telemetry.timed_call
        "mem_samples": 0,
    },
    extra=summary,
    on_reset=_reset_state,
)


def reset() -> None:
    """Zero the counters AND drop the ledger/peaks/watch state
    (registry-managed: ``telemetry.reset_group("memtrack")``)."""
    telemetry.reset_group("memtrack")


# ------------------------------------------------------------------ ledger

def _drop(buf_id: int) -> None:
    rec = _LEDGER.pop(buf_id, None)
    if rec is None:
        return
    _LIVE_BYTES[0] -= rec["nbytes"]
    _LIVE_BY_TAG[rec["tag"]] = _LIVE_BY_TAG.get(rec["tag"], 0) - rec["nbytes"]
    _COUNTERS["released"] += 1


def register_buffer(value, *, tag: str = "leaf", split=None) -> Optional[int]:
    """Ledger one tensor (``events`` level and above; below, the cost is
    one integer compare).  The creation site is the nearest user frame;
    the entry disappears when the tensor is freed.  Re-registering a live
    tensor keeps the first entry and counts a rebind.  Returns the ledger
    key (``id(value)``) or ``None`` when not ledgered."""
    if telemetry._LEVEL < telemetry._EVENTS or not _ENABLED[0]:
        return None
    try:
        nbytes = int(value.element_size()) * int(value.numel())
    except (AttributeError, TypeError):
        return None  # not a tensor
    buf_id = id(value)
    if buf_id in _LEDGER:
        _COUNTERS["rebinds"] += 1
        return buf_id
    try:
        # a plain ref with a death callback; the ref rides the record, so
        # dropping the record (reset) also disarms the callback
        ref = weakref.ref(value, lambda _r, _b=buf_id: _drop(_b))
    except TypeError:
        return None
    _REG_SEQ[0] += 1
    _LEDGER[buf_id] = {
        "id": buf_id,
        "seq": _REG_SEQ[0],
        "nbytes": nbytes,
        "dtype": value.dtype,
        "shape": tuple(value.shape),
        "split": split,
        "device": value.device,
        "tag": tag if tag in TAGS else "leaf",
        "site": guard.format_site(guard.capture_site(2)),
        "ts": time.monotonic(),
        "wr": ref,
    }
    _COUNTERS["registered"] += 1
    _LIVE_BYTES[0] += nbytes
    if _LIVE_BYTES[0] > _PEAK_LIVE[0]:
        _PEAK_LIVE[0] = _LIVE_BYTES[0]
    _tag_add(_LEDGER[buf_id]["tag"], nbytes)
    return buf_id


def tag_buffer(value, tag: str) -> None:
    """Retag a live ledger entry (e.g. a slab read by a data loader as
    ``staging``).  No-op below ``events`` level or for an unledgered
    tensor."""
    if telemetry._LEVEL < telemetry._EVENTS or not _ENABLED[0]:
        return
    rec = _LEDGER.get(id(value))
    if rec is not None and tag in TAGS and tag != rec["tag"]:
        _LIVE_BY_TAG[rec["tag"]] = (
            _LIVE_BY_TAG.get(rec["tag"], 0) - rec["nbytes"]
        )
        rec["tag"] = tag
        _tag_add(tag, rec["nbytes"])


def _distinct(shards):
    seen = set()
    for s in shards:
        if id(s) not in seen:
            seen.add(id(s))
            yield s


def register_shards(shards, *, tag: str = "leaf", split=None) -> None:
    """:func:`register_buffer` for each distinct shard of a split array (a
    replicated array's positions share one tensor); below ``events`` one
    integer compare in all."""
    if telemetry._LEVEL < telemetry._EVENTS or not _ENABLED[0]:
        return
    for s in _distinct(shards):
        register_buffer(s, tag=tag, split=split)


def tag_shards(shards, tag: str) -> None:
    """:func:`tag_buffer` for each distinct shard."""
    if telemetry._LEVEL < telemetry._EVENTS or not _ENABLED[0]:
        return
    for s in _distinct(shards):
        tag_buffer(s, tag)


def _render(rec: dict, now: float) -> dict:
    return {
        "id": rec["id"],
        "nbytes": rec["nbytes"],
        "dtype": str(rec["dtype"]) if rec["dtype"] is not None else None,
        "shape": rec["shape"],
        "split": rec["split"],
        "device": str(rec["device"]),
        "tag": rec["tag"],
        "site": rec["site"],
        "age_s": round(now - rec["ts"], 3),
    }


def live_buffers(top: Optional[int] = 10) -> List[dict]:
    """The live ledger, largest first: one dict per tensor with nbytes,
    dtype, shape, split, device, tag, the creation site (``file:line in
    func``) and age.  ``top`` bounds the list (``None`` = all)."""
    rows = sorted(_LEDGER.values(), key=lambda r: -r["nbytes"])
    if top is not None:
        rows = rows[: max(int(top), 0)]
    now = time.monotonic()
    return [_render(r, now) for r in rows]


def census(top: int = 8) -> dict:
    """The census a postmortem attaches: live count and bytes and the
    top-K tensors with their creation sites."""
    return {
        "live_buffers": len(_LEDGER),
        "live_bytes": _LIVE_BYTES[0],
        "bytes_by_dtype": summary()["bytes_by_dtype"],
        "top": live_buffers(top),
    }


# --------------------------------------------------- unified device readers

# test hook: fake per-device readings ({"bytes_in_use", "bytes_limit"},
# optionally "device") standing in for the card's, so the CPU tests can
# drive the readers and the budget formula
_STATS_OVERRIDE: Optional[List[dict]] = None


def set_stats_override(devices: Optional[List[dict]]) -> Optional[List[dict]]:
    """Install (or clear, with ``None``) simulated per-device readings;
    returns the previous override."""
    global _STATS_OVERRIDE
    prev = _STATS_OVERRIDE
    _STATS_OVERRIDE = list(devices) if devices is not None else None
    return prev


@contextmanager
def stats_override(devices: List[dict]):
    """Scoped :func:`set_stats_override`::

    >>> with memtrack.stats_override([{"bytes_in_use": 900, "bytes_limit": 1000}]):
    ...     assert memtrack.min_free_bytes() == 100
    """
    prev = set_stats_override(devices)
    try:
        yield
    finally:
        set_stats_override(prev)


def _raw_device_stats() -> List[Tuple[str, Optional[dict]]]:
    """``(device, {"bytes_in_use", "bytes_limit"})`` per visible card, from
    the caching allocator (``allocated_bytes.all.current``, the number
    ``torch.cuda.memory_allocated`` gives) and ``mem_get_info``'s total;
    an empty list on the CPU."""
    if _STATS_OVERRIDE is not None:
        return [(str(d.get("device", f"injected:{i}")), d) for i, d in enumerate(_STATS_OVERRIDE)]
    import torch

    if not torch.cuda.is_available():
        return []
    out: List[Tuple[str, Optional[dict]]] = []
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
        out.append((f"cuda:{i}", {"bytes_in_use": int(used), "bytes_limit": _bytes_limit(i)}))
    return out


_LIMITS: Dict[int, int] = {}


def _bytes_limit(index: int) -> int:
    """The card's total memory (``mem_get_info``), read once per card."""
    got = _LIMITS.get(index)
    if got is None:
        import torch

        got = _LIMITS[index] = int(torch.cuda.mem_get_info(index)[1])
    return got


def device_bytes_in_use() -> Tuple[List[Tuple[str, Optional[int]]], Optional[int]]:
    """``(per_device, worst)``: each card's bytes in use and their max
    (``None`` where no card reports, as on the CPU)."""
    per: List[Tuple[str, Optional[int]]] = []
    worst = None
    for name, stats in _raw_device_stats():
        used = stats.get("bytes_in_use") if stats else None
        used = int(used) if used is not None else None
        per.append((name, used))
        if used is not None and (worst is None or used > worst):
            worst = used
    return per, worst


def min_free_bytes() -> Optional[int]:
    """Tightest per-device headroom, ``min(bytes_limit − bytes_in_use)``
    over the cards that report both; ``None`` when none does.  (The
    allocator's view: memory held by other processes is not counted.)"""
    tightest = None
    for _name, stats in _raw_device_stats():
        if not stats:
            continue
        limit = stats.get("bytes_limit")
        used = stats.get("bytes_in_use")
        if limit is None or used is None:
            continue
        free = int(limit) - int(used)
        if tightest is None or free < tightest:
            tightest = free
    return tightest


def suggest_budget(
    request: int,
    *,
    fraction: float = 0.25,
    floor: int = 0,
    headroom: int = 0,
    free: Optional[int] = None,
) -> Optional[int]:
    """The free-memory budget formula, heat_tpu's:
    ``max(floor, min(request, (free - headroom) * fraction))``.

    ``request`` is what the caller would spend without memory pressure;
    ``fraction`` reserves slack for everything else; ``headroom`` is an
    absolute reservation subtracted first.  ``None`` when no device
    reports (the CPU): never a budget from made-up numbers.  Pass
    ``free`` to reuse a reading already taken."""
    if free is None:
        free = min_free_bytes()
        if free is None:
            return None
    granted = int((int(free) - int(headroom)) * float(fraction))
    return max(int(floor), min(int(request), granted))


def would_fit(
    nbytes: int,
    *,
    fraction: float = 0.5,
    headroom: int = 0,
) -> Optional[bool]:
    """Does an ``nbytes`` allocation fit inside :func:`suggest_budget`'s
    budget?  ``None`` where no device reports (the CPU): the caller
    should admit."""
    nbytes = int(nbytes)
    granted = suggest_budget(nbytes, fraction=fraction, headroom=headroom)
    if granted is None:
        return None
    return granted >= nbytes


def device_peaks() -> Dict[str, int]:
    """Max sampled bytes in use per device (fed by :func:`sample_bytes`)."""
    return dict(_DEVICE_PEAKS)


def sample_bytes() -> Tuple[Optional[int], Optional[str]]:
    """One memory reading: ``(bytes, source)``.  The worst card's bytes in
    use (``source="device"``, folding per-device peaks as a side effect);
    where no card reports, the ledger's live bytes (``source="ledger"``,
    only while the ledger records, at ``events``).  ``(None, None)`` when
    neither has data: an honest unknown, never a fake zero."""
    if not _ENABLED[0]:
        return None, None
    per, worst = device_bytes_in_use()
    if worst is not None:
        _COUNTERS["mem_samples"] += 1
        for name, used in per:
            if used is not None and used > _DEVICE_PEAKS.get(name, -1):
                _DEVICE_PEAKS[name] = used
        return worst, "device"
    if telemetry._LEVEL >= telemetry._EVENTS:
        _COUNTERS["mem_samples"] += 1
        return _LIVE_BYTES[0], "ledger"
    return None, None


# ------------------------------------------------------ retention detection

class _MemWatch:
    """Handle yielded by :func:`memwatch`; ``retained`` fills at exit."""

    __slots__ = ("retained", "_mark")

    def __init__(self, mark: int):
        self.retained: List[dict] = []
        self._mark = mark


@contextmanager
def memwatch():
    """Retention scope: every tensor registered inside and still alive at
    exit is a suspect.  Exit runs one ``gc.collect()``, then records the
    survivors on the handle's ``retained`` and module-wide for
    :func:`leaks`::

    >>> with memtrack.memwatch() as w:
    ...     scratch = ht.zeros((4096,), split=0)
    ...     keep = ht.ones((8,), split=0)
    ...     del scratch
    >>> [r["site"] for r in w.retained]   # names keep's creation line
    """
    w = _MemWatch(_REG_SEQ[0])
    try:
        yield w
    finally:
        gc.collect()
        now = time.monotonic()
        w.retained = [
            _render(rec, now)
            for rec in sorted(_LEDGER.values(), key=lambda r: -r["nbytes"])
            if rec["seq"] > w._mark
        ]
        _WATCH_RETAINED[:] = w.retained


def leaks() -> List[dict]:
    """Tensors registered inside the last :func:`memwatch` scope and still
    alive now (``kind="retained"``).  heat_tpu also lists orphaned fusion
    pins (``kind="pin"``); the port has no fusion engine yet.  Empty means
    no evidence of retention."""
    return [dict(row, kind="retained") for row in _WATCH_RETAINED if row["id"] in _LEDGER]
