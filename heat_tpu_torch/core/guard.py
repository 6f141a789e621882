"""Guardrails: the guard's mode, caller attribution and fault-injection
hooks (counterpart of heat_tpu/core/guard.py).

* ``HEAT_TPU_GUARD`` (default ``warn``) sets the mode: ``off``, ``warn``
  (a :class:`NonFiniteWarning`, NumPy's ``RuntimeWarning`` semantics) or
  ``raise`` (``1``/``true``/``strict``/...: a :class:`NonFiniteError`).
  :func:`capture_site` walks the stack to the first frame outside the
  ``heat_tpu_torch`` package, the user line behind a buffer or an op;
  :mod:`~heat_tpu_torch.core.memtrack` stamps it on every buffer it
  ledgers, and every node of the fusion engine's DAG records it.  The
  engine (:mod:`~heat_tpu_torch.core.fusion`) consumes the mode: while it
  is on, each materialization checks its float outputs with one
  reduction and one host read (deferred until the value has landed in
  ``warn`` mode on the card), and a chain whose finite inputs produced
  NaN/Inf is replayed op by op to name the first op, its line and its
  subtree.
* The fault-injection hooks :func:`fire` and :func:`corrupt`: the
  transport engine consults them on every move, so an installed injector
  (heat_tpu's ``utils.fault.FaultInjector``, not ported yet) can raise or
  corrupt at a real call site.  With none installed a hook costs one
  global read.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from typing import Optional, Tuple

__all__ = [
    "NonFiniteError",
    "NonFiniteWarning",
    "capture_site",
    "corrupt",
    "enabled",
    "fire",
    "format_site",
    "guarded",
    "mode",
    "set_enabled",
    "set_mode",
    "strict",
]

# .../heat_tpu_torch: frames whose code lives under this prefix are library
# internals; the first frame outside it is the user line
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep

_MODES = ("off", "warn", "raise")


def _env_mode() -> str:
    raw = os.environ.get("HEAT_TPU_GUARD", "warn").strip().lower()
    if raw in ("off", "0", "false", "no"):
        return "off"
    if raw in ("", "warn", "on", "default"):
        return "warn"
    # 1 / true / yes / raise / strict / error — any explicit escalation
    return "raise"


_MODE = _env_mode()


def mode() -> str:
    """Current guard mode: ``off`` | ``warn`` | ``raise``."""
    return _MODE


def _coerce(m) -> str:
    if m is True:
        return "raise"
    if m is False:
        return "off"
    if m not in _MODES:
        raise ValueError(f"guard mode must be one of {_MODES}, got {m!r}")
    return m


def set_mode(m) -> str:
    """Set the guard mode (``off``/``warn``/``raise``; booleans coerce to
    ``off``/``raise``).  Returns the previous mode."""
    global _MODE
    prev = _MODE
    _MODE = _coerce(m)
    return prev


def enabled() -> bool:
    """Whether the guard is active at all."""
    return _MODE != "off"


def strict() -> bool:
    """Whether a guard trip raises (``raise`` mode) instead of warning."""
    return _MODE == "raise"


def set_enabled(flag) -> str:
    """Boolean-flavored :func:`set_mode` (True → ``raise``, False →
    ``off``); returns the previous mode."""
    return set_mode(flag)


@contextmanager
def guarded(m=True):
    """Scoped :func:`set_mode` (``with guard.guarded(False): ...`` or
    ``guard.guarded("warn")``)."""
    prev = set_mode(m)
    try:
        yield
    finally:
        set_mode(prev)


# filename -> is-library-internal, memoized: startswith on the same
# handful of filenames dominates the frame walk
_INTERNAL_FILE: dict = {}


def capture_site(skip: int = 1) -> Optional[Tuple[str, int, str]]:
    """``(filename, lineno, function)`` of the nearest stack frame outside
    the heat_tpu_torch package: the user line behind the current call.
    ``None`` when every frame within the walk budget is library-internal."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stacks only in embeds
        return None
    cache = _INTERNAL_FILE
    for _ in range(64):
        if f is None:
            return None
        fname = f.f_code.co_filename
        internal = cache.get(fname)
        if internal is None:
            internal = cache[fname] = fname.startswith(_PKG_ROOT)
        if not internal:
            return (fname, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


def format_site(site: Optional[Tuple[str, int, str]]) -> str:
    if site is None:
        return "<heat_tpu_torch internal>"
    fname, lineno, func = site
    return f"{fname}:{lineno} in {func}"


class NonFiniteWarning(RuntimeWarning):
    """A ``warn``-mode guard trip: a computation introduced NaN/Inf.
    Carries the attribution text of :class:`NonFiniteError` but follows
    NumPy's warning semantics (``sqrt(-1)`` warns, it does not throw).
    ``event_id`` is the sequence number of the flight recorder's event for
    the trip (``None`` below ``HEAT_TPU_TELEMETRY=events``)."""

    event_id: Optional[int] = None


class NonFiniteError(FloatingPointError):
    """A guarded computation produced NaN/Inf that its finite inputs did
    not contain (``raise`` mode).

    Attributes:
        op: name of the offending op, or ``None`` when unattributed.
        site: ``(filename, lineno, function)`` of the user line behind it,
            or ``None``.
        subtree: a rendering of the offending op's inputs, or ``None``.
        event_id: sequence number of the flight recorder's event for the
            trip (``None`` below ``HEAT_TPU_TELEMETRY=events``).
    """

    def __init__(self, message: str, *, op=None, site=None, subtree=None):
        super().__init__(message)
        self.op = op
        self.site = site
        self.subtree = subtree
        self.event_id: Optional[int] = None


# ------------------------------------------------------- injection hooks
# An injector (an object with fire_site(site) and corrupt_site(site,
# value)) installed in _INJECTOR is consulted at the real call sites, so
# tests inject faults into production paths instead of mocking them.

_INJECTOR = None


def fire(site: str) -> None:
    """Give the installed injector a chance to raise or stall at ``site``
    (e.g. ``transport.resplit``).  No-op when no injector is installed."""
    if _INJECTOR is not None:
        _INJECTOR.fire_site(site)


def corrupt(site: str, value):
    """Give the installed injector a chance to corrupt ``value`` (NaN
    injection) at ``site``.  Identity when no injector is installed."""
    if _INJECTOR is not None:
        return _INJECTOR.corrupt_site(site, value)
    return value
