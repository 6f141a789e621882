"""Unified telemetry: counter registry, flight recorder, spans, program
ledger (counterpart of heat_tpu/core/telemetry.py, exposed as
``ht.telemetry``).

**Counter registry.**  Every counter group registers once with its
defaults (:func:`register_group`) and gets back the live dict its module
mutates on its hot path (a plain dict increment).  :func:`snapshot`
returns every group as one nested dict, :func:`export_prometheus` the text
exposition format, and :func:`reset_all` / :func:`reset_group` restore the
defaults in place (nested dicts keep their identity, so module-level
aliases stay valid).

**Flight recorder.**  A bounded ring of structured events with monotonic
timestamps and sequence numbers (:func:`record_event`, :func:`events`,
:func:`dump`, :func:`postmortem`).  ``HEAT_TPU_TELEMETRY`` sets the level:

    ``off``       record nothing (no events, no ledger, no spans)
    ``counters``  program ledger on; no events (the default)
    ``events``    + flight recorder + span events
    ``trace``     + ``torch.profiler.record_function`` per span, so the
                  spans' names appear in a torch profiler trace

**Spans.**  :func:`span` is a context manager and a decorator, nested
(parent ids ride the events), wired into the estimators' ``fit`` and the
transport engine.  :func:`open_spans` shows every thread's open spans.

**Program ledger.**  One entry per program fingerprint
(:func:`record_program`, :func:`ensure_program`, :func:`programs`) with
its predicted work, and the measured wall clocks of :func:`timed_call` /
:func:`record_timing`.  heat_tpu fills an entry's ``flops``/``hbm_bytes``
from its cost model at XLA compile time; in the port a kernel site gives
its kernel's own work count (the one PERF.md's bound column uses) and
every other site leaves both ``None``.

Costs: below ``events`` a would-be event or span is one integer compare.
At the default ``counters`` level no call site reads the device or waits
for it: :func:`timed_call` samples every ``HEAT_TPU_TELEMETRY_SAMPLE``-th
call, and a sampled call on the card records two CUDA events that are
read only when a report asks (:func:`programs`), never synchronised on the
path.  A CPU call is timed on the host clock (its work is done when it
returns).
"""

from __future__ import annotations

import copy
import hashlib
import io
import itertools
import json
import os
import re
import sys
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from . import envparse

__all__ = [
    "annotate_program",
    "autotune_report",
    "current_span",
    "dump",
    "ensure_program",
    "events",
    "clear_events",
    "export_prometheus",
    "export_trace",
    "leaks",
    "level",
    "live_buffers",
    "memwatch",
    "open_spans",
    "postmortem",
    "program_hit",
    "programs",
    "record_event",
    "record_peak",
    "record_program",
    "record_timing",
    "register_group",
    "reset_all",
    "reset_group",
    "reset_programs",
    "roofline_report",
    "router_report",
    "serving_report",
    "set_capacity",
    "set_level",
    "set_sample_every",
    "snapshot",
    "snapshot_group",
    "span",
    "telemetry_level",
    "timed_call",
    "timing_active",
]


# ------------------------------------------------------------------- levels
# Ordered modes; each includes everything below it.  Integers so the hot
# gate (`if _LEVEL < _EVENTS: return`) is one compare.

_LEVELS = ("off", "counters", "events", "trace")
_OFF, _COUNTERS, _EVENTS, _TRACE = range(4)


def _env_level() -> int:
    raw = os.environ.get("HEAT_TPU_TELEMETRY", "counters").strip().lower()
    if raw in ("off", "0", "false", "no", "none"):
        return _OFF
    if raw in ("", "counters", "on", "default"):
        return _COUNTERS
    if raw == "events":
        return _EVENTS
    if raw == "trace":
        return _TRACE
    return _COUNTERS


_LEVEL = _env_level()


def level() -> str:
    """Current telemetry level: ``off`` | ``counters`` | ``events`` |
    ``trace`` (``HEAT_TPU_TELEMETRY``)."""
    return _LEVELS[_LEVEL]


def set_level(lvl) -> str:
    """Set the level by name (or int rank); returns the previous name."""
    global _LEVEL
    prev = _LEVELS[_LEVEL]
    if isinstance(lvl, str):
        if lvl not in _LEVELS:
            raise ValueError(f"level must be one of {_LEVELS}, got {lvl!r}")
        _LEVEL = _LEVELS.index(lvl)
    else:
        _LEVEL = min(max(int(lvl), _OFF), _TRACE)
    return prev


@contextmanager
def telemetry_level(lvl):
    """Scoped :func:`set_level` (``with telemetry.telemetry_level("events")``)."""
    prev = set_level(lvl)
    try:
        yield
    finally:
        set_level(prev)


def ledger_enabled() -> bool:
    """Whether the cost ledger records (``counters`` level and above)."""
    return _LEVEL >= _COUNTERS


def events_enabled() -> bool:
    """Whether the flight recorder records (``events`` level and above)."""
    return _LEVEL >= _EVENTS


def trace_enabled() -> bool:
    """Whether spans enter ``torch.profiler.record_function`` (``trace``)."""
    return _LEVEL >= _TRACE


# ----------------------------------------------------------- metrics registry

class _Group:
    __slots__ = ("name", "live", "defaults", "extra", "on_reset")

    def __init__(self, name, live, defaults, extra, on_reset):
        self.name = name
        self.live = live
        self.defaults = defaults
        self.extra = extra
        self.on_reset = on_reset


_GROUPS: "OrderedDict[str, _Group]" = OrderedDict()


def register_group(
    name: str,
    defaults: Dict[str, Any],
    *,
    extra: Optional[Callable[[], Dict[str, Any]]] = None,
    on_reset: Optional[Callable[[], None]] = None,
) -> Dict[str, Any]:
    """Register a named counter group and return its LIVE dict.

    The owning module mutates the returned dict directly (plain dict
    increments — registration adds zero hot-path cost).  ``defaults`` is
    deep-copied both at registration and on every reset, so the reset
    contract lives in exactly one place: add a counter to the defaults
    and :func:`reset_group` handles it forever.  ``extra`` contributes
    derived read-only fields to snapshots (e.g. a cache's live ``size``);
    ``on_reset`` runs extra reset work (e.g. clearing a side table).

    Re-registering an existing name returns the already-live dict (the
    registration is idempotent across module reloads)."""
    got = _GROUPS.get(name)
    if got is not None:
        return got.live
    live = copy.deepcopy(defaults)
    _GROUPS[name] = _Group(name, live, copy.deepcopy(defaults), extra, on_reset)
    return live


def _reset_in_place(live: dict, defaults: dict) -> None:
    """Restore ``defaults`` into ``live`` without replacing nested dict
    objects, so module-level aliases into the group stay valid."""
    for k in list(live.keys()):
        if k not in defaults:
            del live[k]
    for k, dv in defaults.items():
        cur = live.get(k)
        if isinstance(dv, dict) and isinstance(cur, dict):
            _reset_in_place(cur, dv)
        else:
            live[k] = copy.deepcopy(dv)


def reset_group(name: str) -> None:
    """Restore one group to its registered defaults (in place)."""
    g = _GROUPS[name]
    _reset_in_place(g.live, g.defaults)
    if g.on_reset is not None:
        g.on_reset()


def reset_all() -> None:
    """Restore EVERY registered group to its defaults — the single reset
    that replaces the hand-maintained per-module ones."""
    for name in _GROUPS:
        reset_group(name)


def snapshot_group(name: str) -> Dict[str, Any]:
    """Deep-copied snapshot of one group, with its ``extra`` fields
    merged in."""
    g = _GROUPS[name]
    out = copy.deepcopy(g.live)
    if g.extra is not None:
        out.update(g.extra())
    return out


def snapshot() -> Dict[str, Dict[str, Any]]:
    """Every registered counter group as ONE nested dict:
    ``{"transport": {...}, "stream": {...}, "memtrack": {...}, ...}``."""
    return {name: snapshot_group(name) for name in _GROUPS}


_METRIC_SAFE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_lines(prefix: str, value, lines: List[str], src: str = "") -> None:
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        lines.append(f"# HELP {prefix} heat_tpu telemetry gauge {src or prefix}")
        lines.append(f"# TYPE {prefix} gauge")
        lines.append(f"{prefix} {value}")
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _prom_lines(
                f"{prefix}_{_METRIC_SAFE.sub('_', str(k))}", v, lines,
                src=f"{src}.{k}" if src else str(k),
            )
    # None / strings / other payloads have no numeric exposition — skipped


_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _label_escape(s) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(s))


# per-program roofline gauges emitted for at most this many programs
# (the heaviest by measured total time), keeping scrapes bounded
_PROM_PROGRAMS_MAX = 16


def _program_prom_lines(lines: List[str]) -> None:
    """Labeled ``heat_tpu_program_*`` gauges for the measured programs:
    calls/seconds plus the roofline attribution, keyed by
    ``{fingerprint=...,kind=...}``."""
    from . import roofline

    rows = roofline.report(programs(), top=_PROM_PROGRAMS_MAX)["rows"]
    fields = (
        "calls", "total_s", "min_s", "p50_s", "achieved_gflops",
        "achieved_gbps", "frac_compute_roofline", "frac_hbm_roofline",
    )
    for f in fields:
        samples = []
        for r in rows:
            v = r.get(f)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            labels = (
                f'fingerprint="{_label_escape(r["fingerprint"])}"'
                f',kind="{_label_escape(r.get("kind") or "")}"'
            )
            samples.append(f"heat_tpu_program_{f}{{{labels}}} {v}")
        if samples:
            name = f"heat_tpu_program_{f}"
            lines.append(f"# HELP {name} heat_tpu telemetry gauge "
                         f"measured per-program {f}")
            lines.append(f"# TYPE {name} gauge")
            lines.extend(samples)


def _mem_prom_lines(lines: List[str]) -> None:
    """``heat_tpu_mem_*`` gauges from the residency ledger: live bytes,
    live buffer count, the ledger high-water mark, and per-device sampled
    peaks (labeled by device)."""
    from . import memtrack

    s = memtrack.summary()
    peaks = memtrack.device_peaks()
    for name, val, help_ in (
        ("heat_tpu_mem_live_bytes", s["live_bytes"],
         "bytes held by ledgered live buffers"),
        ("heat_tpu_mem_live_buffers", s["live_buffers"],
         "count of ledgered live buffers"),
        ("heat_tpu_mem_peak_live_bytes", s["peak_live_bytes"],
         "high-water mark of ledgered live bytes"),
    ):
        lines.append(f"# HELP {name} heat_tpu telemetry gauge {help_}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {val}")
    if peaks:
        name = "heat_tpu_mem_device_peak_bytes"
        lines.append(f"# HELP {name} heat_tpu telemetry gauge max sampled "
                     f"bytes_in_use per device")
        lines.append(f"# TYPE {name} gauge")
        for dev, val in peaks.items():
            lines.append(f'{name}{{device="{_label_escape(dev)}"}} {val}')
    if s.get("bytes_by_dtype"):
        name = "heat_tpu_mem_bytes_by_dtype"
        lines.append(f"# HELP {name} heat_tpu telemetry gauge ledgered "
                     f"live bytes per buffer dtype")
        lines.append(f"# TYPE {name} gauge")
        for dt, val in sorted(s["bytes_by_dtype"].items()):
            lines.append(f'{name}{{dtype="{_label_escape(dt)}"}} {val}')


def _wire_prom_lines(lines: List[str]) -> None:
    """Labeled per-program wire gauges for the ledger entries that ship a
    quantized wire format: the f32 bytes the program would have moved
    (``heat_tpu_wire_program_logical_bytes``), what its format moved
    (``heat_tpu_wire_program_bytes``) and their ratio, keyed by
    ``{fingerprint=...,arm=...}``."""
    rows = [e for e in programs() if e.get("wire") and isinstance(e.get("wire_bytes"), (int, float))]
    if not rows:
        return
    for field, metric, help_ in (
        ("logical_bytes", "heat_tpu_wire_program_logical_bytes",
         "f32 bytes the program's collective would move uncompressed"),
        ("wire_bytes", "heat_tpu_wire_program_bytes", "bytes the program's quantized wire format moves"),
    ):
        lines.append(f"# HELP {metric} heat_tpu telemetry gauge {help_}")
        lines.append(f"# TYPE {metric} gauge")
        for e in rows:
            labels = f'fingerprint="{_label_escape(e["fingerprint"])}",arm="{_label_escape(e["wire"])}"'
            lines.append(f"{metric}{{{labels}}} {float(e.get(field) or 0.0)}")
    metric = "heat_tpu_wire_program_ratio"
    lines.append(f"# HELP {metric} heat_tpu telemetry gauge logical/wire byte compression ratio")
    lines.append(f"# TYPE {metric} gauge")
    for e in rows:
        wb = float(e.get("wire_bytes") or 0.0)
        lb = float(e.get("logical_bytes") or 0.0)
        if wb <= 0.0:
            continue
        labels = f'fingerprint="{_label_escape(e["fingerprint"])}",arm="{_label_escape(e["wire"])}"'
        lines.append(f"{metric}{{{labels}}} {round(lb / wb, 4)}")


def export_prometheus() -> str:
    """Text exposition format (``# HELP`` + ``# TYPE gauge`` + one value
    line per numeric leaf): every registered group flattened as
    ``heat_tpu_<group>_<counter>`` (label-unsafe characters in group and
    counter names escaped to ``_``; the ``# HELP`` line keeps the
    original dotted path), plus labeled per-program
    ``heat_tpu_program_*`` gauges for the measured roofline rows and the
    ``heat_tpu_mem_*`` residency gauges and the per-program
    ``heat_tpu_wire_program_*`` gauges.  Non-numeric fields are
    skipped."""
    lines: List[str] = []
    for name in _GROUPS:
        _prom_lines(
            f"heat_tpu_{_METRIC_SAFE.sub('_', name)}", snapshot_group(name),
            lines, src=name,
        )
    _program_prom_lines(lines)
    _mem_prom_lines(lines)
    _wire_prom_lines(lines)
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------- flight recorder

def _env_capacity() -> int:
    return envparse.env_int("HEAT_TPU_TELEMETRY_CAPACITY", 2048)


_RING: "deque[dict]" = deque(maxlen=_env_capacity())
_SEQ = itertools.count()
_DROPPED = [0]  # events evicted by the ring bound (list: mutable module slot)


def set_capacity(n: int) -> int:
    """Resize the ring buffer (keeps the newest events that fit).
    Returns the previous capacity."""
    global _RING
    prev = _RING.maxlen
    _RING = deque(_RING, maxlen=max(int(n), 1))
    return prev


# event keys the recorder itself owns; caller fields shadowing them are
# re-keyed with an "x_" prefix instead of corrupting the envelope
_RESERVED_FIELDS = frozenset(("seq", "ts", "kind", "span", "tid"))


def record_event(kind: str, /, **fields) -> Optional[int]:
    """Append one structured event to the flight recorder.

    Returns the event's sequence number, or ``None`` below ``events``
    level (the no-record gate is one integer compare — safe to call on
    hot paths unconditionally).  Events carry a monotonic ``ts``, the
    recording thread's ident (``tid`` — the trace-export lane), the
    calling thread's innermost open span id (``span``), and the caller's
    ``fields`` (a field named like an envelope key — ``kind``/``seq``/
    ``ts``/``span``/``tid`` — is stored re-keyed as ``x_<name>``)."""
    if _LEVEL < _EVENTS:
        return None
    seq = next(_SEQ)
    if len(_RING) == _RING.maxlen:
        _DROPPED[0] += 1
    cur = _span_stack()
    evt = {
        "seq": seq,
        "ts": time.monotonic(),
        "kind": kind,
        "span": cur[-1].id if cur else None,
        "tid": threading.get_ident(),
    }
    for k, v in fields.items():
        evt[f"x_{k}" if k in _RESERVED_FIELDS else k] = v
    _RING.append(evt)
    return seq


def events(kind: Optional[str] = None, since: Optional[int] = None) -> List[dict]:
    """The recorded events, oldest first; ``kind`` filters.  ``since`` is
    an incremental-read cursor: only events with a sequence number
    strictly greater than it are returned, so an external poller can feed
    the last ``seq`` it saw back in instead of re-scanning the ring."""
    got = list(_RING)
    if since is not None:
        got = [e for e in got if e["seq"] > since]
    if kind is not None:
        got = [e for e in got if e["kind"] == kind]
    return got


def clear_events() -> None:
    """Drop the recorded events (tests/benchmarks)."""
    _RING.clear()
    _DROPPED[0] = 0


def dump(file=None) -> None:
    """Write a postmortem document — level, open spans, the full event
    ring, the program ledger, and a counters snapshot — as one JSON
    object.  ``file`` is a path or a writable handle (default stderr)."""
    doc = {
        "telemetry_level": level(),
        "capacity": _RING.maxlen,
        "dropped": _DROPPED[0],
        "open_spans": open_spans(),
        "events": events(),
        "programs": programs(),
        "counters": snapshot(),
    }
    from . import memtrack

    # who held device memory at dump time: the top live buffers with their
    # creation sites
    doc["buffers"] = memtrack.census(top=16)
    if isinstance(file, (str, os.PathLike)):
        with open(file, "w") as fh:
            json.dump(doc, fh, indent=1, default=repr)
        return
    out = file or sys.stderr
    json.dump(doc, out, indent=1, default=repr)
    out.write("\n")


def postmortem(reason: str, **fields) -> None:
    """Degradation dump (the transport engine calls it when a move fails).
    Records a ``postmortem`` event; when ``HEAT_TPU_TELEMETRY_DUMP`` names
    a path, the full :func:`dump` document is written there with a
    sibling ``<path>.trace.json`` Chrome-trace rendering
    (:func:`export_trace`); a repeated postmortem in one process appends
    ``.2``, ``.3``, ... instead of overwriting the first.  No-op below
    ``events`` level."""
    if _LEVEL < _EVENTS:
        return
    record_event("postmortem", reason=reason, **fields)
    path = os.environ.get("HEAT_TPU_TELEMETRY_DUMP", "").strip()
    if not path:
        return
    try:
        final = path
        n = 1
        while os.path.exists(final):
            n += 1
            final = f"{path}.{n}"
        dump(final)
        export_trace(f"{final}.trace.json")
    except OSError:  # a broken dump path must never mask the real failure
        pass


# ------------------------------------------------------------- span tracing

class _SpanState:
    __slots__ = ("id", "name", "parent", "t0")

    def __init__(self, sid, name, parent, t0):
        self.id = sid
        self.name = name
        self.parent = parent
        self.t0 = t0


_SPAN_IDS = itertools.count(1)
_TLS = threading.local()
# thread ident -> that thread's open-span stack; lets another thread see
# what the workload had in flight
_ALL_STACKS: Dict[int, List[_SpanState]] = {}


def _span_stack() -> List[_SpanState]:
    got = getattr(_TLS, "stack", None)
    if got is None:
        got = _TLS.stack = []
    return got


def current_span() -> Optional[dict]:
    """``{"id", "name", "parent"}`` of the calling thread's innermost
    open span, or ``None``."""
    cur = _span_stack()
    if not cur:
        return None
    s = cur[-1]
    return {"id": s.id, "name": s.name, "parent": s.parent}


def open_spans() -> List[dict]:
    """Every open span across all threads, outermost first per thread."""
    out = []
    for tid, stack in list(_ALL_STACKS.items()):
        for s in list(stack):
            out.append(
                {"thread": tid, "id": s.id, "name": s.name, "parent": s.parent}
            )
    return out


class span:
    """Context manager AND decorator marking one timed region.

    ``with telemetry.span("transport.resplit", tile_bytes=tb): ...`` or::

        @telemetry.span("kmeans.fit")
        def fit(self, x): ...

    At ``events`` level, entry/exit append ``span_begin``/``span_end``
    events carrying the span id, its parent id (nesting), the ``attrs``,
    and the wall duration; every event recorded inside the region carries
    the span's id.  At ``trace`` level the region also enters
    ``torch.profiler.record_function(name)``, so it lands in a torch
    profiler trace.  Below ``events`` level enter/exit are a single
    integer compare each."""

    __slots__ = ("name", "attrs", "_state", "_annot")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._state = None
        self._annot = None

    def __call__(self, fn: Callable) -> Callable:
        import functools

        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return wrapped

    def __enter__(self) -> "span":
        if _LEVEL < _EVENTS:
            return self
        stack = _span_stack()
        parent = stack[-1].id if stack else None
        st = _SpanState(next(_SPAN_IDS), self.name, parent, time.monotonic())
        # record_event BEFORE pushing, so span_begin carries the PARENT id
        # in its own `span` field (the begin belongs to the enclosing span)
        seq = record_event(
            "span_begin", id=st.id, name=self.name, parent=parent,
            **self.attrs,
        )
        del seq
        stack.append(st)
        _ALL_STACKS[threading.get_ident()] = stack
        self._state = st
        if _LEVEL >= _TRACE:
            import torch

            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        st = self._state
        if st is None:
            return False
        self._state = None
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            finally:
                self._annot = None
        stack = _span_stack()
        while stack and stack[-1].id != st.id:  # tolerate unbalanced exits
            stack.pop()
        if stack:
            stack.pop()
        if not stack:
            _ALL_STACKS.pop(threading.get_ident(), None)
        record_event(
            "span_end", id=st.id, name=st.name, parent=st.parent,
            dur_s=round(time.monotonic() - st.t0, 6),
            **({"status": "error", "error": exc_type.__name__}
               if exc_type is not None else {}),
        )
        return False


# ------------------------------------------------------------ program ledger

_PROGRAMS: "OrderedDict[str, dict]" = OrderedDict()
_PROGRAMS_MAX = 1024


def fingerprint(parts) -> str:
    """Short stable digest of a canonical program description."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode())
    return h.hexdigest()[:12]


def record_program(
    fp: str,
    *,
    kind: str = "program",
    n_roots: int = 1,
    ops: int = 0,
    flops: Optional[float] = None,
    hbm_bytes: Optional[float] = None,
    mesh: Optional[dict] = None,
    **extra,
) -> None:
    """Ledger one program under its fingerprint with its predicted work:
    ``flops`` and ``hbm_bytes`` are a kernel site's own work count (the
    operations and the bytes of PERF.md's bound), ``None`` elsewhere.
    Re-recording a fingerprint refreshes the entry and counts a compile
    without touching its hits.  No-op at ``off`` level."""
    if _LEVEL < _COUNTERS:
        return
    got = _PROGRAMS.get(fp)
    hits = got["hits"] if got else 0
    compiles = (got["compiles"] if got else 0) + 1
    _PROGRAMS[fp] = {
        "fingerprint": fp,
        "kind": kind,
        "n_roots": int(n_roots),
        "ops": int(ops),
        "flops": None if flops is None else float(flops),
        "hbm_bytes": None if hbm_bytes is None else float(hbm_bytes),
        "mesh": mesh,
        "compiles": compiles,
        "hits": hits,
        **extra,
    }
    _PROGRAMS.move_to_end(fp)
    while len(_PROGRAMS) > _PROGRAMS_MAX:
        old, _ = _PROGRAMS.popitem(last=False)
        _TIMINGS.pop(old, None)


def ensure_program(fp: Optional[str], **kwargs) -> None:
    """Ledger a program the first time its fingerprint is seen and count a
    hit every later time (heat_tpu's first-sighting-vs-rest
    approximation of compiles-vs-hits; the port compiles no programs, so
    ``compiles`` is 1 for every entry)."""
    if fp is None or _LEVEL < _COUNTERS:
        return
    got = _PROGRAMS.get(fp)
    if got is None:
        record_program(fp, **kwargs)
    else:
        got["hits"] += 1


def program_hit(fp: Optional[str]) -> None:
    """Count one more execution of a ledgered program."""
    if fp is None or _LEVEL < _COUNTERS:
        return
    got = _PROGRAMS.get(fp)
    if got is not None:
        got["hits"] += 1


def annotate_program(fp: Optional[str], **fields) -> None:
    """Merge extra fields into an existing ledger entry without touching
    its compile/hit counts.  No-op for an unseen fingerprint."""
    if fp is None or _LEVEL < _COUNTERS:
        return
    got = _PROGRAMS.get(fp)
    if got is not None:
        got.update(fields)


def programs() -> List[dict]:
    """The program ledger, oldest entry first: one dict per program with
    ``fingerprint``, ``kind``, ``n_roots``, ``ops``, ``flops``,
    ``hbm_bytes``, ``mesh``, ``compiles`` and ``hits``, and for programs
    with measured executions ``calls``, ``total_s``, ``min_s`` and
    ``p50_s``.  Reading it resolves the finished CUDA-event timings that
    :func:`timed_call` left pending (a host read of two events each)."""
    _resolve_pending()
    return [dict(v, **_timing_view(fp)) for fp, v in _PROGRAMS.items()]


def reset_programs() -> None:
    """Drop the ledger (tests, benchmarks)."""
    _PROGRAMS.clear()
    _TIMINGS.clear()
    _PENDING.clear()


# ------------------------------------------------ measured program timing
# Measured wall clocks, kept beside the ledger entries so re-recording a
# fingerprint keeps its history.

_TIMINGS: Dict[str, dict] = {}
_TIMING_SAMPLES = 64  # per-program reservoir backing the p50 estimate
_TICK = itertools.count()
# (fingerprint, start event, end event, observer) of sampled card calls
# whose events are read only when a report asks
_PENDING: "deque[tuple]" = deque()
_PENDING_MAX = 4096


def _env_sample_every() -> int:
    return envparse.env_int("HEAT_TPU_TELEMETRY_SAMPLE", 16)


_SAMPLE_EVERY = _env_sample_every()


def set_sample_every(n: int) -> int:
    """Set the ``counters``-level sampling period (every Nth call of
    :func:`timed_call` is timed; ``HEAT_TPU_TELEMETRY_SAMPLE``, default
    16).  Returns the previous period."""
    global _SAMPLE_EVERY
    prev = _SAMPLE_EVERY
    _SAMPLE_EVERY = max(int(n), 1)
    return prev


def timing_active() -> bool:
    """Whether this call of :func:`timed_call` is timed: never below
    ``counters``, every call at ``events`` and above, every Nth call at
    ``counters``."""
    if _LEVEL < _COUNTERS:
        return False
    if _LEVEL >= _EVENTS:
        return True
    return next(_TICK) % _SAMPLE_EVERY == 0


def _timing(fp: str) -> dict:
    t = _TIMINGS.get(fp)
    if t is None:
        t = _TIMINGS[fp] = {
            "calls": 0,
            "total_s": 0.0,
            "min_s": float("inf"),
            "samples": deque(maxlen=_TIMING_SAMPLES),
        }
    return t


def record_timing(fp: Optional[str], dur_s: float) -> None:
    """Accumulate one measured wall clock under a fingerprint
    (``calls``/``total_s``/``min_s`` and a bounded reservoir for
    ``p50_s``).  External timers may call this directly."""
    if fp is None or _LEVEL < _COUNTERS:
        return
    t = _timing(fp)
    t["calls"] += 1
    t["total_s"] += dur_s
    if dur_s < t["min_s"]:
        t["min_s"] = dur_s
    t["samples"].append(dur_s)


def record_peak(fp: Optional[str], peak_bytes, source: Optional[str] = None) -> None:
    """Fold one memory reading into a program's measured view (max over
    samples).  ``source`` says how it was read: ``device`` (the caching
    allocator's bytes in use) or ``ledger`` (memtrack's live bytes)."""
    if fp is None or peak_bytes is None or _LEVEL < _COUNTERS:
        return
    t = _timing(fp)
    if int(peak_bytes) > t.get("peak_bytes", -1):
        t["peak_bytes"] = int(peak_bytes)
        t["mem_source"] = source


def _resolve_pending(wait: bool = True) -> None:
    """Fold the pending CUDA-event timings into their programs, oldest
    first: all of them, waiting for the card (the reports), or with
    ``wait=False`` only those whose events have completed."""
    while _PENDING:
        fp, start, end, observer = _PENDING[0]
        if not wait and not end.query():
            return
        _PENDING.popleft()
        if wait:
            end.synchronize()
        dur = start.elapsed_time(end) / 1e3
        record_timing(fp, dur)
        if observer is not None:
            observer(dur)


def _timing_view(fp: str) -> dict:
    t = _TIMINGS.get(fp)
    if t is None:
        return {}
    out = {}
    if t["calls"]:
        ordered = sorted(t["samples"])
        out = {
            "calls": t["calls"],
            "total_s": round(t["total_s"], 6),
            "min_s": round(t["min_s"], 6),
            "p50_s": round(ordered[len(ordered) // 2], 6),
        }
    if "peak_bytes" in t:
        out["peak_bytes"] = t["peak_bytes"]
        out["mem_source"] = t.get("mem_source")
    return out


def timed_call(fp: Optional[str], fn: Callable, *args, observer=None, device=None):
    """``fn(*args)``, timed under ``fp`` when the sampling gate fires.

    On the card (``device`` a CUDA device) a sampled call records a CUDA
    event before and after ``fn`` on the current stream and leaves the
    pair pending: nothing waits for the card here, and :func:`programs`
    reads the elapsed time later.  Elsewhere the host clock times the call
    (CPU work is done when ``fn`` returns).  Around a sampled call the
    memory reading (:func:`memtrack.sample_bytes`, the allocator's host
    counters) gives the program a ``peak_bytes`` and, at ``events``, the
    recorder a ``mem_sample`` trail.  ``observer`` sees each sampled
    duration.  With ``fp=None`` or an idle gate this is a plain call."""
    if fp is None or not timing_active():
        return fn(*args)
    from . import memtrack

    b0, src0 = memtrack.sample_bytes()
    if b0 is not None:
        record_event("mem_sample", fingerprint=fp, bytes_in_use=b0, source=src0)
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        _PENDING.append((fp, start, end, observer))
        if len(_PENDING) > _PENDING_MAX:
            # fold what has finished; a sample still running past the
            # bound is dropped rather than waited for
            _resolve_pending(wait=False)
            while len(_PENDING) > _PENDING_MAX:
                _PENDING.popleft()
    else:
        t0 = time.perf_counter()
        out = fn(*args)
        dur = time.perf_counter() - t0
        record_timing(fp, dur)
        if observer is not None:
            observer(dur)
    b1, src1 = memtrack.sample_bytes()
    if b1 is not None:
        record_event("mem_sample", fingerprint=fp, bytes_in_use=b1, source=src1)
    peak = max((b for b in (b0, b1) if b is not None), default=None)
    record_peak(fp, peak, src1 or src0)
    return out


def roofline_report(top: Optional[int] = None, peaks: Optional[dict] = None) -> dict:
    """Measured-vs-peak attribution of every ledgered program with
    measured time (:func:`heat_tpu_torch.core.roofline.report`):
    ``{"device", "peaks", "rows", "memory_bound_tail"}``, rows sorted by
    total measured time, the verdict ``unknown-peak`` where the device's
    peaks are unknown (``HEAT_TPU_PEAKS`` overrides them).  Rows whose
    fingerprint carries a program-audit finding (a host read, an unmodeled
    collective, a dead donation) are marked ``audited_dirty``: their time is
    not trustworthy attribution."""
    from . import roofline
    from ..analysis import program_audit

    rep = roofline.report(programs(), top=top, peaks=peaks)
    dirty = program_audit.dirty_fingerprints()
    if dirty:
        for row in rep.get("rows", ()):
            if row.get("fingerprint") in dirty:
                row["audited_dirty"] = True
    return rep


# ------------------------------------------------------------- memory axis
# The residency ledger lives in core/memtrack.py; these delegators surface
# its queries here, as heat_tpu's do.

def live_buffers(top: Optional[int] = 10) -> List[dict]:
    """The live buffer ledger, largest buffer first (see
    :func:`heat_tpu_torch.core.memtrack.live_buffers`)."""
    from . import memtrack

    return memtrack.live_buffers(top=top)


def leaks() -> List[dict]:
    """Buffers that outlived a ``memwatch()`` scope (see
    :func:`heat_tpu_torch.core.memtrack.leaks`)."""
    from . import memtrack

    return memtrack.leaks()


def memwatch():
    """Retention-detection scope (see
    :func:`heat_tpu_torch.core.memtrack.memwatch`)."""
    from . import memtrack

    return memtrack.memwatch()


def autotune_report(top: Optional[int] = None) -> dict:
    """The tuning table (:func:`heat_tpu_torch.core.autotune.report`)."""
    from . import autotune

    return autotune.report(top=top)


def serving_report() -> dict:
    """Snapshot of the ``serving`` counter group (registered when
    :mod:`heat_tpu_torch.serving` is imported): accepted/rejected/batch/shed
    counters and each endpoint's latency p50/p99.  An empty dict until the
    serving front door has been imported."""
    if "serving" not in _GROUPS:
        return {}
    return snapshot_group("serving")


def router_report() -> dict:
    """Snapshot of the ``router`` counter group (registered when
    :mod:`heat_tpu_torch.serving.router` is imported): dispatch, spill,
    failover and retry counters, circuit-breaker transitions (ejections,
    half-opens, probes, recoveries) and rolling-swap outcomes.  An empty
    dict until the fleet router has been imported."""
    if "router" not in _GROUPS:
        return {}
    return snapshot_group("router")


def reset() -> None:
    """Full telemetry reset: counters, events and the ledger."""
    reset_all()
    clear_events()
    reset_programs()


# --------------------------------------------------------------- trace export

# event keys owned by the recorder envelope / span identity; everything
# else a span or event carries becomes Chrome-trace ``args``
_TRACE_ENVELOPE = frozenset(("seq", "ts", "kind", "span", "tid", "id",
                             "name", "parent"))


def export_trace(file=None) -> List[dict]:
    """Render the flight recorder as Chrome-trace JSON (the array-of-
    events form Perfetto's legacy JSON importer loads): one ``B``/``E``
    duration-event pair per span (one lane per recording thread, so
    nesting renders as a flame), and an ``i`` instant event for every
    non-span event — guard blames, OOM retries, fallbacks, dispatch
    decisions, stall heartbeats.  Timestamps are microseconds relative to
    the oldest recorded event.  Spans still open at export are closed at
    the last recorded timestamp with ``status: open``; a span whose begin
    was evicted from the ring is synthesized from the end event's
    recorded duration (its nesting may render approximate).  Returns the
    event list; ``file`` (path or handle) additionally writes it as
    JSON."""
    evs = events()
    pid = os.getpid()
    out: List[dict] = []
    lanes: Dict[int, int] = {}

    def lane(raw_tid) -> int:
        got = lanes.get(raw_tid)
        if got is None:
            got = lanes[raw_tid] = len(lanes)
            out.append({
                "ph": "M", "ts": 0, "pid": pid, "tid": got,
                "name": "thread_name", "cat": "__metadata",
                "args": {"name": f"thread-{got}"},
            })
        return got

    t0 = evs[0]["ts"] if evs else 0.0

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 3)

    begun: Dict[int, dict] = {}
    for e in evs:
        tid = lane(e.get("tid", 0))
        args = {k: v for k, v in e.items() if k not in _TRACE_ENVELOPE}
        kind = e["kind"]
        if kind == "span_begin":
            begun[e["id"]] = e
            out.append({"ph": "B", "ts": us(e["ts"]), "pid": pid, "tid": tid,
                        "cat": "span", "name": e["name"], "args": args})
        elif kind == "span_end":
            if e["id"] not in begun:
                out.append({
                    "ph": "B",
                    "ts": us(e["ts"] - float(e.get("dur_s") or 0.0)),
                    "pid": pid, "tid": tid, "cat": "span", "name": e["name"],
                    "args": {"synthesized": "begin evicted from ring"},
                })
            begun.pop(e["id"], None)
            out.append({"ph": "E", "ts": us(e["ts"]), "pid": pid, "tid": tid,
                        "cat": "span", "name": e["name"], "args": args})
        elif kind == "mem_sample":
            # counter track: Perfetto renders the "C" series as a memory
            # timeline beside the span lanes (one track per recording lane)
            out.append({"ph": "C", "ts": us(e["ts"]), "pid": pid, "tid": tid,
                        "cat": "memory", "name": "memory",
                        "args": {"bytes_in_use": e.get("bytes_in_use", 0)}})
        else:
            out.append({"ph": "i", "s": "t", "ts": us(e["ts"]), "pid": pid,
                        "tid": tid, "cat": "event", "name": kind,
                        "args": args})
    if evs:
        t_last = us(evs[-1]["ts"])
        # close innermost-first so each lane's B/E stack stays balanced
        for e in reversed(list(begun.values())):
            out.append({"ph": "E", "ts": t_last, "pid": pid,
                        "tid": lane(e.get("tid", 0)), "cat": "span",
                        "name": e["name"], "args": {"status": "open"}})
    if isinstance(file, (str, os.PathLike)):
        with open(file, "w") as fh:
            json.dump(out, fh, indent=1, default=repr)
    elif file is not None:
        json.dump(out, file, indent=1, default=repr)
    return out


# The recorder/ledger's own health gauges, registered as a group so they
# ride snapshot()/export_prometheus() like any subsystem group (the
# `events_dropped` count is the ring's eviction pressure — a poller
# seeing it grow between scrapes knows its `since=` cursor lost data).
register_group(
    "telemetry",
    {},
    extra=lambda: {
        "level": level(),
        "capacity": _RING.maxlen,
        "events": len(_RING),
        "events_dropped": _DROPPED[0],
        "programs": len(_PROGRAMS),
    },
)


# ------------------------------------------------------------- convenience

def describe() -> str:
    """One human-readable status block (debugging aid)."""
    buf = io.StringIO()
    buf.write(f"telemetry level={level()} capacity={_RING.maxlen} "
              f"events={len(_RING)} dropped={_DROPPED[0]} "
              f"programs={len(_PROGRAMS)}\n")
    for name in _GROUPS:
        buf.write(f"  [{name}] {snapshot_group(name)}\n")
    return buf.getvalue()
