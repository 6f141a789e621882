"""Program audit tier of the SPMD hazard analyzer (counterpart of
heat_tpu/analysis/program_audit.py; ``HEAT_TPU_AUDIT=1``).

Hooked into the three sites that build programs (the fusion engine's cache
miss, the transport engine's programs and the overlap engine's rings), each
program is audited once per (kind, fingerprint).  The port has no jaxpr and
no compiled module to walk, so the audit watches the program's first run
under the audit instead:

* **use_after_donate**: an input the sanitizer's poison ledger says was
  donated already (checked on every call; the auditor registers interest,
  so donation sites poison while the raising sanitizer is off).
* **host_transfer**: a read of a tensor's value by the host inside the run.
  A ``torch.overrides.TorchFunctionMode`` sees ``item``, ``tolist``,
  ``numpy``, ``bool``/``int``/``float``/``index`` of a tensor, and ``cpu`` or
  ``to("cpu")`` of a tensor off the CPU, on every device; on the card
  ``torch.cuda.set_sync_debug_mode("warn")`` adds the syncs that torch makes
  inside an operation.
* **unexpected_collective**: a collective (``parallel/collectives.py`` or an
  engine dispatch reported to ``sanitize.collective_event``) in a program
  whose caller declared it local (``expect="none"``).
* **unexpected_reshard** (``HEAT_TPU_AUDIT=hlo``): a data-rearranging
  collective (an all-gather, an all-to-all, a ring hop, a transport
  program) in a program declared local or local-plus-reduce
  (``expect="reduce"``: a fused chain's cross-position reductions are
  expected).
* **donation_unaliasable**: a donated input whose byte size matches no
  output.  It applies where a caller names donated inputs; the port's three
  sites donate nothing (the fusion engine has no ``donate=`` and transport
  writes new shards), so it does not fire there.

Findings become ``analysis_finding`` events carrying the program's
fingerprint, and :func:`heat_tpu_torch.core.telemetry.roofline_report` marks
those rows ``audited_dirty``.  ``audit_errors`` stays 0: a watched run that
raises raises.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..core import telemetry
from . import sanitize

__all__ = ["audit_program", "audited", "dirty_fingerprints", "enabled", "findings", "mode", "reset", "set_mode",
           "watched"]

# ------------------------------------------------------------------- gating

_MODE_OVERRIDE: "List[Optional[str]]" = [None]

_VALID_MODES = ("off", "jaxpr", "hlo")


def mode() -> str:
    """``off`` | ``jaxpr`` | ``hlo`` (``HEAT_TPU_AUDIT``: unset/0 = off,
    1/on/jaxpr = the watched run, hlo = the watched run with the reshard
    rule).  heat_tpu's names are kept; the port has no jaxpr or HLO."""
    if _MODE_OVERRIDE[0] is not None:
        return _MODE_OVERRIDE[0]
    raw = os.environ.get("HEAT_TPU_AUDIT", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return "off"
    if raw == "hlo":
        return "hlo"
    return "jaxpr"


def enabled() -> bool:
    return mode() != "off"


def set_mode(m: Optional[str]) -> Optional[str]:
    """Override the env toggle (``None`` restores env control).  Returns
    the previous override."""
    if m is not None and m not in _VALID_MODES:
        raise ValueError(f"audit mode must be one of {_VALID_MODES}, got {m!r}")
    prev = _MODE_OVERRIDE[0]
    _MODE_OVERRIDE[0] = m
    return prev


# donation sites poison for the auditor even when the raising sanitizer is off
sanitize.register_interest(enabled)

# ----------------------------------------------------------------- findings

_FINDINGS: List[dict] = []
_BY_FP: Dict[str, List[dict]] = {}
_SEEN: set = set()

# named "audit", as heat_tpu's group
_STATS = telemetry.register_group(
    "audit",
    {
        "audits": 0,        # programs watched (once per kind + fingerprint)
        "findings": 0,      # hazards recorded
        "audit_errors": 0,  # kept for heat_tpu's keys: a watched run that raises raises
    },
)

# collectives that rearrange data between positions (the reshard rule);
# psum/pmin/pmax and the prefix scan are reductions
_RESHARD = frozenset({"all_gather", "all_to_all", "ppermute", "ring_shift", "bcast", "resplit", "reshape",
                      "rechunk", "take", "ring_ag", "ring_rs", "ring_col"})
_HOST_READS = frozenset({"item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__", "__complex__"})


def findings(fp: Optional[str] = None) -> List[dict]:
    """All recorded findings, or those of one fingerprint."""
    if fp is not None:
        return list(_BY_FP.get(fp, ()))
    return list(_FINDINGS)


def dirty_fingerprints() -> set:
    """Fingerprints with at least one finding: the roofline marks these
    rows ``audited_dirty``."""
    return set(_BY_FP)


def reset() -> None:
    del _FINDINGS[:]
    _BY_FP.clear()
    _SEEN.clear()


def _record(kind: str, fp: Optional[str], rule: str, detail: str) -> dict:
    finding = {"kind": kind, "fingerprint": fp, "rule": rule, "detail": detail}
    _FINDINGS.append(finding)
    if fp is not None:
        _BY_FP.setdefault(fp, []).append(finding)
    _STATS["findings"] += 1
    telemetry.record_event("analysis_finding", kind=kind, fingerprint=fp, rule=rule, detail=detail)
    return finding


# ---------------------------------------------------------------- the watch


def _tensors(value) -> List[torch.Tensor]:
    """The tensors of a program argument or output (a tensor, a DNDarray's
    shards, or lists and tuples of them)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    shards = value.__dict__.get("_DNDarray__shards") if hasattr(value, "__dict__") else None
    if shards is not None:
        return list(shards)
    return []


def _nbytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(value))


def _off_cpu(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type not in ("cpu", "meta")


class _HostReads(TorchFunctionMode):
    """Records each read of a tensor's value by the host."""

    def __init__(self):
        super().__init__()
        self.seen: List[str] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _HOST_READS:
            self.seen.append(name)
        elif name == "cpu" and args and _off_cpu(args[0]):
            self.seen.append("cpu")
        elif name == "to" and args and _off_cpu(args[0]):
            dest = kwargs.get("device", args[1] if len(args) > 1 else None)
            if isinstance(dest, (str, torch.device)) and torch.device(dest).type == "cpu":
                self.seen.append("to(cpu)")
        return func(*args, **kwargs)


def _run_watched(fn, args, on_card: bool):
    """``fn(*args)`` with the collectives and the host reads it makes."""
    from ..parallel import collectives

    colls: List[str] = []
    collectives._WATCHERS.append(colls.append)
    sanitize._WATCHERS.append(colls.append)
    reads = _HostReads()
    syncs: list = []
    prev_sync = None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                prev_sync = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with reads:
                    out = fn(*args)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(prev_sync)
        syncs = [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]
        for w in caught:
            if "called a synchronizing" not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    finally:
        collectives._WATCHERS.remove(colls.append)
        sanitize._WATCHERS.remove(colls.append)
    return out, colls, reads.seen, syncs


def _audit(kind: str, fp: Optional[str], fn, args: Sequence, donate: Tuple[int, ...], expect: str):
    got: List[dict] = []
    # inputs already donated elsewhere: checked on every call, since one
    # program can be fed a clean buffer once and a donated one the next
    for i, a in enumerate(args):
        for t in _tensors(a):
            entry = sanitize.poison_entry(t)
            if entry is not None:
                got.append(_record(
                    kind, fp, "use_after_donate",
                    f"input {i} was donated at {entry['donated']} (buffer created at {entry['created']}) and is fed "
                    "back into this program",
                ))
                break
    key = (kind, fp) if fp is not None else (
        kind, tuple((tuple(t.shape), str(t.dtype)) for a in args for t in _tensors(a)), tuple(donate), expect,
    )
    if key in _SEEN:
        return fn(*args), got
    _SEEN.add(key)
    _STATS["audits"] += 1
    on_card = torch.cuda.is_available() and any(t.is_cuda for a in args for t in _tensors(a))
    out, colls, reads, syncs = _run_watched(fn, args, on_card)

    if reads or syncs:
        got.append(_record(
            kind, fp, "host_transfer",
            f"host read(s) {sorted(set(reads))}" + (f" and synchronizing call(s) at {syncs}" if syncs else "")
            + " inside the program: a device-to-host round trip per dispatch",
        ))
    seen = sorted(set(colls))
    if expect == "none" and seen:
        got.append(_record(
            kind, fp, "unexpected_collective",
            f"collective(s) {seen} in a program the cost ledger modeled as local",
        ))
    if mode() == "hlo" and expect in ("none", "reduce"):
        moved = sorted(set(colls) & _RESHARD)
        if moved:
            got.append(_record(
                kind, fp, "unexpected_reshard",
                f"data-rearranging collective(s) {moved} in a program modeled as "
                f"{'local' if expect == 'none' else 'local+reduce'}: the roofline row's time includes unmodeled "
                "traffic",
            ))
    out_sizes = [t.numel() * t.element_size() for t in _tensors(out)]
    for i in donate:
        if i >= len(args):
            continue
        nb = _nbytes(args[i])
        if nb not in out_sizes and nb != sum(out_sizes):
            got.append(_record(
                kind, fp, "donation_unaliasable",
                f"donated input {i} ({nb} bytes) matches no output (outputs: {out_sizes}): the buffer is given up "
                "for nothing",
            ))
    return out, got


def audit_program(kind: str, fp: Optional[str], fn, args: Sequence, donate: Tuple[int, ...] = (),
                  expect: str = "any") -> List[dict]:
    """Audit one program; returns the findings it produced.  ``fn(*args)``
    runs once under the watch (the port's counterpart of heat_tpu's trace),
    on its first sighting per (kind, fingerprint); its output is dropped.
    ``donate`` names donated argument positions; ``expect`` is the
    collective contract the caller's cost model assumed: ``"any"``
    (transport, overlap), ``"reduce"`` (fused chains) or ``"none"``."""
    if not enabled():
        return []
    return _audit(kind, fp, fn, tuple(args), tuple(donate), expect)[1]


def audited(kind: str, fp: Optional[str], fn, args: Sequence, donate: Tuple[int, ...] = (), expect: str = "any"):
    """``fn(*args)``, audited as :func:`audit_program` audits it: the
    compile sites' entry, which runs the program once."""
    if not enabled():
        return fn(*args)
    return _audit(kind, fp, fn, tuple(args), tuple(donate), expect)[0]


def watched(kind: str, fp: Optional[str], fn, donate: Tuple[int, ...] = (), expect: str = "any"):
    """``fn`` wrapped so that each call runs through :func:`audited`."""
    def run(*args):
        return audited(kind, fp, fn, args, donate, expect)

    return run
