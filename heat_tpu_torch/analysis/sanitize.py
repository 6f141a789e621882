"""The runtime sanitizer (counterpart of heat_tpu/analysis/sanitize.py),
``HEAT_TPU_SANITIZE=1``.

Two jobs, both near-zero when off:

* **Donated-tensor poisoning.**  A donation site (``quantize_weights(...,
  donate=True)``) reports the consumed master here; the transport entries
  ask :func:`check_use` on their inputs, and a poisoned tensor raises
  :class:`UseAfterDonateError` naming its creation site (from the memtrack
  ledger) and its donation site.  A callee cannot free a tensor its caller
  still holds, so in the port donation is this poison plus memtrack's
  ``donated`` tag, and the owner drops its own reference.

* **Collective-sequence fingerprint.**  Every transport program that
  moves data between positions appends ``(site, op, axis)`` to a
  per-process hash chain: the lockstep law that several processes will
  have to keep (identical on every rank).

Poison entries hold a weakref to the donated tensor: a dead referent whose
``id`` was recycled must never convict a new tensor, so :func:`check_use`
confirms identity through the weakref before raising.
"""

import hashlib
import os
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..core import guard, memtrack, telemetry

__all__ = [
    "UseAfterDonateError",
    "check_use",
    "clear_poison",
    "collective_event",
    "collective_fingerprint",
    "enabled",
    "poison",
    "poison_entry",
    "register_interest",
    "reset",
    "reset_collective_fingerprint",
    "set_enabled",
]

# ------------------------------------------------------------------- gating

_ENABLED_OVERRIDE: "List[Optional[bool]]" = [None]

# callables that keep the poison bookkeeping live while the raising
# sanitizer is off (an auditor's hook; sanitize never imports its users)
_AUX_INTEREST: "List[Any]" = []


def enabled() -> bool:
    """Whether the raising sanitizer is live (``HEAT_TPU_SANITIZE``,
    default off)."""
    if _ENABLED_OVERRIDE[0] is not None:
        return _ENABLED_OVERRIDE[0]
    return os.environ.get("HEAT_TPU_SANITIZE", "").strip().lower() in ("1", "on", "true", "yes")


def set_enabled(on: Optional[bool]) -> Optional[bool]:
    """Override the env toggle (``None`` restores env control).  Returns
    the previous override."""
    prev = _ENABLED_OVERRIDE[0]
    _ENABLED_OVERRIDE[0] = None if on is None else bool(on)
    return prev


def register_interest(fn) -> None:
    """Register a zero-argument callable; poison bookkeeping also runs
    while any registered callable returns True."""
    if fn not in _AUX_INTEREST:
        _AUX_INTEREST.append(fn)


def _tracking() -> bool:
    if enabled():
        return True
    for fn in _AUX_INTEREST:
        try:
            if fn():
                return True
        except Exception:
            pass
    return False


# ------------------------------------------------------------ poison ledger


class UseAfterDonateError(RuntimeError):
    """A donated tensor was fed back into an engine entry point."""


# id(tensor) -> {"ref": weakref|None, "created": site, "donated": site,
#                "nbytes": int, "shape": tuple, "dtype": str}
_POISON: Dict[int, dict] = {}
_POISON_MAX = 4096  # bounded: a long-lived process must not grow this

_STATS = telemetry.register_group(
    "sanitize",
    {
        "poisoned": 0,           # donation sites reported
        "checks": 0,             # check_use consults while tracking
        "use_after_donate": 0,   # raised hits
        "collective_events": 0,  # fingerprint chain appends
    },
)


def _nbytes(value) -> int:
    try:
        return int(value.element_size()) * int(value.numel())
    except (AttributeError, TypeError):
        return int(getattr(value, "nbytes", 0) or 0)


def poison(value, donated_site: Optional[str] = None) -> None:
    """Record ``value`` as donated.  Called by a donation site after the
    donating call (which is the legitimate last use).  The creation site
    comes from the memtrack ledger when the tensor was ledgered, else it
    is captured here."""
    if value is None or not _tracking():
        return
    rec = memtrack._LEDGER.get(id(value))
    created = rec.get("site") if rec is not None else None
    if donated_site is None:
        donated_site = guard.format_site(guard.capture_site(2))
    try:
        ref = weakref.ref(value)
    except TypeError:
        ref = None
    if len(_POISON) >= _POISON_MAX:
        _POISON.pop(next(iter(_POISON)), None)
    _POISON[id(value)] = {
        "ref": ref,
        "created": created or "<unledgered buffer>",
        "donated": donated_site,
        "nbytes": _nbytes(value),
        "shape": tuple(getattr(value, "shape", ()) or ()),
        "dtype": str(getattr(value, "dtype", "?")),
    }
    _STATS["poisoned"] += 1


def poison_entry(value) -> Optional[dict]:
    """The poison record for ``value`` if it is a confirmed donated tensor
    (the weakref identity check defeats id reuse), else None."""
    entry = _POISON.get(id(value))
    if entry is None:
        return None
    ref = entry.get("ref")
    if ref is not None and ref() is not value:
        # the donated tensor died and its id was recycled: this is a
        # different, innocent object
        del _POISON[id(value)]
        return None
    return entry


def check_use(value, context: str) -> None:
    """Raise :class:`UseAfterDonateError` if ``value`` (a tensor, or a list
    of shards) was donated.  No-op unless the sanitizer is enabled."""
    if not enabled() or value is None:
        return
    if isinstance(value, (list, tuple)):
        for v in value:
            check_use(v, context)
        return
    _STATS["checks"] += 1
    entry = poison_entry(value)
    if entry is None:
        return
    _STATS["use_after_donate"] += 1
    telemetry.record_event(
        "analysis_finding", rule="use_after_donate", context=context,
        created=entry["created"], donated=entry["donated"], nbytes=entry["nbytes"],
    )
    raise UseAfterDonateError(
        f"use-after-donate in {context}: this "
        f"{entry['dtype']}{list(entry['shape'])} tensor "
        f"({entry['nbytes']} bytes) was donated at "
        f"{entry['donated']} and must not be read again. "
        f"Tensor created at {entry['created']}. Copy it before the "
        "donating call, or keep the DNDarray instead of its raw tensor."
    )


def clear_poison() -> None:
    _POISON.clear()


# ----------------------------------------------- collective-sequence chain

# the running fingerprint: a hash chain over (site, op, axis), identical
# across ranks iff every rank ran the same collectives in the same order
_CHAIN = {"n": 0, "digest": hashlib.sha256(b"heat_tpu").hexdigest()}
_WATCHERS: "List[Any]" = []
_TRAIL: "List[Tuple[str, str, Optional[str]]]" = []
_TRAIL_MAX = 256


def collective_event(op: str, axis: Optional[str] = None, site: Optional[str] = None) -> None:
    """Append one collective dispatch to the per-process chain.  Gated on
    the sanitizer toggle: the steady state pays one boolean check.  The
    program auditor's watchers (``_WATCHERS``) see every dispatch."""
    for w in _WATCHERS:
        w(op)
    if not enabled():
        return
    if site is None:
        site = guard.format_site(guard.capture_site(2))
    link = f"{site}|{op}|{axis or ''}"
    _CHAIN["digest"] = hashlib.sha256((_CHAIN["digest"] + link).encode()).hexdigest()
    _CHAIN["n"] += 1  # ht: HT004 ok — hash-chain state, not a counter; sanitize._STATS carries the counters
    _STATS["collective_events"] += 1
    if len(_TRAIL) < _TRAIL_MAX:
        _TRAIL.append((site, op, axis))


def collective_fingerprint() -> dict:
    """The current chain: ``{"n", "digest", "trail"}`` (trail bounded)."""
    return {"n": _CHAIN["n"], "digest": _CHAIN["digest"], "trail": list(_TRAIL)}


def reset_collective_fingerprint() -> None:
    _CHAIN["n"] = 0
    _CHAIN["digest"] = hashlib.sha256(b"heat_tpu").hexdigest()
    del _TRAIL[:]


def reset() -> None:
    """Full sanitizer reset (tests)."""
    clear_poison()
    reset_collective_fingerprint()
