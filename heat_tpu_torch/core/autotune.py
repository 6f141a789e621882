"""The tuning plane (counterpart of heat_tpu/core/autotune.py): measured
explore/exploit dispatch, memory-seeded budgets and a persisted warm-start
table.

A dispatch site with several arms that compute the same thing consults
:func:`decide` under a key of its geometry: while any arm of the entry has
fewer than :func:`explore_k` samples (``HEAT_TPU_AUTOTUNE_EXPLORE``,
default 3) the call explores, running every arm under :func:`timed` and
returning the reference arm's result; then the arm with the least
``min_s`` serves alone.  A served winner whose sampled time degrades past
2x its recorded best on two consecutive samples goes back to explore.
:func:`save`/:func:`load` keep the table as versioned JSON stamped with the
library version; ``HEAT_TPU_AUTOTUNE_CACHE`` loads it at import, so a
restarted process replays its winners with no explore call.

The port's sites: the quantized arms (``bf16``/``int8``,
:mod:`~heat_tpu_torch.core.quantize`) and the wire formats (``wire_f32``/
``wire_int8``/``wire_fp8``, :mod:`~heat_tpu_torch.core.wire`).  The kernel
sites K4-K7 keep a one-arm entry ``("kernel",)`` under heat_tpu's keys: on
a CUDA tensor they launch their kernel on every call whatever the table
holds and only record its timing, so :func:`report` shows each
geometry's ``kernel_min_s`` and the degradation watch runs.  A CPU tensor
consults no table.

Every decision is an ``autotune_decision`` event and a count in the
``autotune`` group; :func:`report` (also ``telemetry.autotune_report()``)
renders the table.  ``HEAT_TPU_AUTOTUNE=off`` restores the static
dispatch.  :func:`device_kind` is ``gpu:<the card's name>`` where torch
sees a card, else ``cpu:cpu``."""

import json
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from . import memtrack, telemetry
from .envparse import env_int
from .version import __version__

__all__ = [
    "ARMS",
    "CACHE_VERSION",
    "Decision",
    "KERNEL_ARMS",
    "decide",
    "device_kind",
    "dtype_name",
    "enabled",
    "env_bytes",
    "env_int",
    "explore_k",
    "kernel_key",
    "load",
    "matmul_key",
    "merge",
    "note_budget_seed",
    "note_prior",
    "observe",
    "QUANT_ARMS",
    "quant_key",
    "report",
    "reset",
    "salt",
    "save",
    "set_enabled",
    "SPMV_ARMS",
    "spmv_key",
    "stats",
    "STREAM_ARMS",
    "stream_key",
    "kernel_site",
    "site_tunes",
    "table",
    "timed",
    "WIRE_ARMS",
    "winner",
    "wire_key",
]

# heat_tpu's arm sets, kept so that a table saved by either package loads
# in the other
ARMS = ("ring", "gspmd")
KERNEL_ARMS = ("classic", "kernel")
# the port's kernel sites: one arm, the hand-written kernel
KERNEL_ONLY = ("kernel",)
QUANT_ARMS = ("bf16", "int8")
WIRE_ARMS = ("wire_f32", "wire_int8", "wire_fp8")
SPMV_ARMS = ("dense", "gather", "kernel")
STREAM_ARMS = ("slab_full", "slab_half", "slab_quarter")
# every arm name any entry may carry; load() refuses anything else, so a
# corrupt cache cannot inject an arm no site dispatches
_KNOWN_ARMS = (
    frozenset(ARMS) | frozenset(KERNEL_ARMS) | frozenset(QUANT_ARMS)
    | frozenset(WIRE_ARMS) | frozenset(SPMV_ARMS) | frozenset(STREAM_ARMS)
)
CACHE_VERSION = 1

# samples kept per arm: enough for the explore phase and the degradation
# evidence, bounded so a long-lived process never grows its entries
_MAX_SAMPLES = 16

# a served winner this many times slower than its recorded best, on this
# many consecutive sampled calls, goes back to explore
_DEGRADE_FACTOR = 2.0
_DEGRADE_STRIKES = 2


# --------------------------------------------------------------- env parsing


def env_bytes(name: str, default: int, env: Optional[dict] = None) -> int:
    """The byte-sized env knob parser (``HEAT_TPU_TILE_BYTES``,
    ``HEAT_TPU_WIRE_MIN_BYTES``): empty or unset gives ``default``; a
    malformed or non-positive value raises ``ValueError`` naming the
    variable."""
    raw = (os.environ if env is None else env).get(name, "").strip()
    if not raw:
        return int(default)
    try:
        val = int(raw)
        if val <= 0:
            raise ValueError
    except ValueError:
        raise ValueError(f"{name} must be a positive integer (bytes), got {raw!r}") from None
    return val


def explore_k() -> int:
    """Measured samples per arm before a winner is declared
    (``HEAT_TPU_AUTOTUNE_EXPLORE``, default 3)."""
    raw = os.environ.get("HEAT_TPU_AUTOTUNE_EXPLORE", "").strip()
    if not raw:
        return 3
    try:
        k = int(raw)
        if k <= 0:
            raise ValueError
    except ValueError:
        raise ValueError(f"HEAT_TPU_AUTOTUNE_EXPLORE must be a positive integer, got {raw!r}") from None
    return k


# ------------------------------------------------------------------ enabling

# None: follow the env var; a bool: the API override
_ENABLED_OVERRIDE: "list[Optional[bool]]" = [None]


def enabled() -> bool:
    """Whether the tuning plane is live (``HEAT_TPU_AUTOTUNE``, default
    on).  Off restores the static dispatch: no exploration, no table
    lookups, no budget seeding."""
    if _ENABLED_OVERRIDE[0] is not None:
        return _ENABLED_OVERRIDE[0]
    return os.environ.get("HEAT_TPU_AUTOTUNE", "on").strip().lower() not in ("off", "0", "false", "no")


def set_enabled(on: Optional[bool]) -> Optional[bool]:
    """Override the env toggle (``None`` restores env control); returns the
    previous override."""
    prev = _ENABLED_OVERRIDE[0]
    _ENABLED_OVERRIDE[0] = None if on is None else bool(on)
    if prev is not _ENABLED_OVERRIDE[0]:
        _GENERATION[0] += 1
    return prev


# ------------------------------------------------------------- tuning table

# (fingerprint, device_kind) -> {"arms": {arm: [durations]}, "winner",
#   "best_s", "strikes", "loaded", "desc"}
_TABLE: Dict[Tuple[str, str], dict] = {}

# bumped whenever a decision could flip (resolve, re-explore, load, toggle,
# reset)
_GENERATION = [0]

_STATS = telemetry.register_group(
    "autotune",
    {
        "decisions": 0,         # every consult that returned an arm
        "explores": 0,          # calls that ran every arm under measurement
        "cache_hits": 0,        # decisions served by a resolved winner
        "cache_loads": 0,       # entries restored by load()
        "priors": 0,            # decisions that fell back to the static prior
        "budget_seeds": 0,      # budgets shrunk from measured free memory
        "staging_declines": 0,  # staging refused by the memory budget
        "re_explores": 0,       # winners sent back to explore on degradation
        "fallbacks": 0,         # corrupt or stale cache files ignored
        "saves": 0,
    },
    extra=lambda: {
        "enabled": enabled(),
        "table_size": len(_TABLE),
        "resolved": sum(1 for e in _TABLE.values() if e["winner"]),
        "generation": _GENERATION[0],
    },
)


def stats() -> Dict[str, Any]:
    """Snapshot of the ``autotune`` counter group (Prometheus:
    ``heat_tpu_autotune_*``)."""
    return telemetry.snapshot_group("autotune")


def table() -> Dict[Tuple[str, str], dict]:
    """A copy of the live tuning table (tests, debugging)."""
    return {k: {**e, "arms": {a: list(d) for a, d in e["arms"].items()}} for k, e in _TABLE.items()}


def reset() -> None:
    """Drop every entry and bump the generation.  The counters belong to
    telemetry (``telemetry.reset_all()``): a counter reset keeps the
    table."""
    _TABLE.clear()
    _GENERATION[0] += 1


def salt() -> tuple:
    """The dispatch-relevant state ``(enabled, generation)``, for caches
    keyed on dispatch decisions."""
    return ("autotune", enabled(), _GENERATION[0])


def _entry(key: Tuple[str, str], desc: str = "", arms: Tuple[str, ...] = ARMS) -> dict:
    e = _TABLE.get(key)
    if e is None:
        e = _TABLE[key] = {
            "arms": {a: [] for a in arms},
            "winner": None,
            "best_s": None,
            "strikes": 0,
            "loaded": False,
            "desc": desc,
        }
    elif desc and not e["desc"]:
        e["desc"] = desc
    return e


def table_size() -> int:
    return len(_TABLE)


def winner(key: Tuple[str, str]) -> Optional[str]:
    """Resolved winner for ``key``, or ``None`` (exploring or unseen).  A
    hit counts as a served decision (the consume-only consult)."""
    e = _TABLE.get(key)
    if e is None or e["winner"] is None:
        return None
    _STATS["decisions"] += 1
    _STATS["cache_hits"] += 1
    telemetry.record_event(
        "autotune_decision", fingerprint=key[0], device_kind=key[1], arm=e["winner"],
        source="cached", site="chain", times=_arm_times(e),
    )
    return e["winner"]


def _arm_times(e: dict) -> Dict[str, Optional[float]]:
    return {a + "_min_s": round(min(d), 6) if d else None for a, d in e["arms"].items()}


# ------------------------------------------------------------------ devices

_DEVICE_KIND: "list[Optional[str]]" = [None]


def device_kind() -> str:
    """``platform:kind``: ``gpu:<torch.cuda.get_device_name(0)>`` where
    torch sees a card, ``cpu:cpu`` otherwise, so a table never crosses
    device kinds.  Cached; never raises."""
    if _DEVICE_KIND[0] is None:
        try:
            import torch

            if torch.cuda.is_available():
                _DEVICE_KIND[0] = f"gpu:{torch.cuda.get_device_name(0)}"
            else:
                _DEVICE_KIND[0] = "cpu:cpu"
        except Exception:
            return "unknown"
    return _DEVICE_KIND[0]


def dtype_name(dt) -> str:
    """heat_tpu's spelling of a dtype in a key (``"float32"``, not
    ``torch.float32``): ``telemetry.fingerprint`` hashes ``str`` of each
    part, so both packages fingerprint a geometry alike."""
    return str(dt).replace("torch.", "")


def matmul_key(case: str, out_split, m: int, k: int, n: int, size: int, comp: str) -> Tuple[str, str]:
    """Key of one sharded GEMM geometry (heat_tpu's ring-vs-GSPMD site)."""
    return telemetry.fingerprint(("matmul", case, out_split, m, k, n, size, comp)), device_kind()


def kernel_key(site: str, *geometry) -> Tuple[str, str]:
    """Key of one kernel site (``reshape_repack``, ``qr_panel``,
    ``lasso_sweep``) at one geometry, spelled as heat_tpu spells it (dtypes
    as ``"float32"``), so both packages fingerprint a geometry alike."""
    return telemetry.fingerprint(("kernel", site) + tuple(geometry)), device_kind()


def quant_key(site: str, *geometry) -> Tuple[str, str]:
    """Key of one quantized-weight site (``linear``, ``moe_ffn``) at one
    geometry; its arms are :data:`QUANT_ARMS`."""
    return telemetry.fingerprint(("quant", site) + tuple(geometry)), device_kind()


def spmv_key(site: str, *geometry) -> Tuple[str, str]:
    """Key of one sparse-product site (``spmv_csr``) at one sparsity
    geometry (shape, nnz bucket, slab capacity, ELL width, right-hand
    sides, dtype, mesh size)."""
    return telemetry.fingerprint(("spmv", site) + tuple(geometry)), device_kind()


def wire_key(site: str, *geometry) -> Tuple[str, str]:
    """Key of one wire-format site (``resplit``, ``rechunk``) at one
    geometry; its arms are :data:`WIRE_ARMS`."""
    return telemetry.fingerprint(("wire", site) + tuple(geometry)), device_kind()


def stream_key(site: str, *geometry) -> Tuple[str, str]:
    """Key of one streaming pass at one source geometry; its arms are
    :data:`STREAM_ARMS`."""
    return telemetry.fingerprint(("stream", site) + tuple(geometry)), device_kind()


# ---------------------------------------------------------------- decisions


class Decision(NamedTuple):
    arm: str          # what to run (explore: run every arm, return this one's result)
    source: str       # "explored" | "cached" | "prior"
    explore: bool     # run every arm under measurement this call
    key: Tuple[str, str]


def decide(key: Tuple[str, str], prior_arm: str, desc: str = "", arms: Tuple[str, ...] = ARMS) -> Decision:
    """One dispatch consult.  While any arm has fewer than
    :func:`explore_k` samples the call explores; a resolved entry serves
    its winner.  ``arms`` names the entry's arm set on first touch."""
    e = _entry(key, desc, arms)
    if e["winner"] is not None:
        _STATS["decisions"] += 1
        _STATS["cache_hits"] += 1
        telemetry.record_event(
            "autotune_decision", fingerprint=key[0], device_kind=key[1], arm=e["winner"],
            source="cached", loaded=e["loaded"], times=_arm_times(e),
        )
        return Decision(e["winner"], "cached", False, key)
    _STATS["decisions"] += 1
    _STATS["explores"] += 1
    telemetry.record_event(
        "autotune_decision", fingerprint=key[0], device_kind=key[1], arm=prior_arm,
        source="explored", explore=True, **{a + "_samples": len(d) for a, d in e["arms"].items()},
    )
    return Decision(prior_arm, "explored", True, key)


def note_prior(key: Tuple[str, str], arm: str, site: str = "chain") -> None:
    """Record that a site fell back to its static prior (no winner yet and
    the site cannot explore)."""
    _STATS["decisions"] += 1
    _STATS["priors"] += 1
    telemetry.record_event("autotune_decision", fingerprint=key[0], device_kind=key[1], arm=arm,
                           source="prior", site=site)


def observe(key: Tuple[str, str], arm: str, dur_s: float) -> None:
    """Fold one measured time into ``key``'s arm.  Resolves the winner once
    every arm holds :func:`explore_k` samples (argmin of the per-arm
    ``min_s``).  On a resolved entry this is the degradation watch:
    ``_DEGRADE_STRIKES`` consecutive samples slower than
    ``_DEGRADE_FACTOR`` times the best send it back to explore."""
    e = _TABLE.get(key)
    if e is None:
        e = _entry(key)
    if e["winner"] is not None:
        if arm != e["winner"] or not e["best_s"]:
            return
        if dur_s > _DEGRADE_FACTOR * e["best_s"]:
            e["strikes"] += 1
            if e["strikes"] >= _DEGRADE_STRIKES:
                _STATS["re_explores"] += 1
                telemetry.record_event(
                    "autotune_reexplore", fingerprint=key[0], device_kind=key[1], arm=arm,
                    observed_s=round(dur_s, 6), best_s=round(e["best_s"], 6),
                )
                e["arms"] = {a: [] for a in e["arms"]}
                e["winner"] = None
                e["best_s"] = None
                e["strikes"] = 0
                e["loaded"] = False
                _GENERATION[0] += 1
        else:
            e["strikes"] = 0
        return
    durs = e["arms"].setdefault(arm, [])
    durs.append(float(dur_s))
    del durs[:-_MAX_SAMPLES]
    k = explore_k()
    if all(len(d) >= k for d in e["arms"].values()):
        mins = {a: min(d) for a, d in e["arms"].items()}
        e["winner"] = min(mins, key=mins.get)
        e["best_s"] = mins[e["winner"]]
        e["strikes"] = 0
        _GENERATION[0] += 1
        telemetry.record_event(
            "autotune_decision", fingerprint=key[0], device_kind=key[1], arm=e["winner"],
            source="explored", resolved=True, times={a + "_min_s": round(v, 6) for a, v in mins.items()},
        )


def _on_card(out) -> bool:
    """Whether ``out`` (a tensor, a DNDarray, or a list, tuple or dict of
    them) holds a CUDA tensor."""
    if isinstance(out, (list, tuple)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    shards = getattr(out, "shards", None)
    if shards is not None and not callable(shards):
        return _on_card(list(shards))
    dev = getattr(out, "device", None)
    return getattr(dev, "type", None) == "cuda"


def timed(fn: Callable, *args) -> Tuple[Any, float]:
    """``(fn(*args), wall seconds)``, fenced by ``torch.cuda.synchronize()``
    when the result lies on the card: the explore-phase measurement."""
    t0 = time.perf_counter()
    out = fn(*args)
    if _on_card(out):
        import torch

        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ------------------------------------------------------ kernel sites


def site_tunes(t) -> bool:
    """Whether a kernel site consults the table for its operand ``t``: the
    tuning plane is on and ``t`` lies on the card (a CPU tensor runs the
    kernel's plain version and touches no table)."""
    return enabled() and getattr(getattr(t, "device", None), "type", None) == "cuda"


def kernel_site(key: Tuple[str, str], desc: str, run: Callable, *args, fp: Optional[str] = None, device=None):
    """One call of a kernel site on the card: ``run(*args)`` launches the
    kernel every time, whatever the table holds.  The site's one-arm entry
    ``("kernel",)`` under ``key`` records its time: fenced by
    :func:`timed` while the entry explores, then through
    ``telemetry.timed_call`` with the degradation watch as its observer
    (sampled, no host sync)."""
    d = decide(key, "kernel", desc=desc, arms=KERNEL_ONLY)
    if d.explore:
        out, dur = timed(run, *args)
        observe(key, "kernel", dur)
        telemetry.record_timing(fp, dur)
        return out
    return telemetry.timed_call(fp, run, *args, observer=lambda dur: observe(key, "kernel", dur), device=device)


# ------------------------------------------------------- memory seeding


def note_budget_seed(site: str, granted: int, default: int) -> None:
    """Ledger one budget shrunk from measured free memory."""
    _STATS["budget_seeds"] += 1
    telemetry.record_event("autotune_budget", site=site, budget=int(granted), default=int(default),
                           free_bytes=memtrack.min_free_bytes())


def note_staging_decline(key: Tuple[str, str], need: int, granted: int) -> None:
    """Ledger a dispatch refused because its staging would not fit the
    measured free memory."""
    _STATS["staging_declines"] += 1
    telemetry.record_event("autotune_budget", site="ring_staging", fingerprint=key[0], device_kind=key[1],
                           need=int(need), budget=int(granted), declined=True)


# ---------------------------------------------------------------- warm start


def _write_doc(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def save(path) -> int:
    """Persist the table as versioned JSON (atomically: a temporary file
    and ``os.replace``), stamped with the library version; :func:`load`
    refuses any other.  Returns the number of entries written."""
    entries = [
        {
            "fingerprint": fp,
            "device_kind": dk,
            "winner": e["winner"],
            "best_s": _finite(e["best_s"]),
            "desc": e["desc"],
            "arms": {a: [_finite(t) for t in d] for a, d in e["arms"].items()},
        }
        for (fp, dk), e in _TABLE.items()
    ]
    path = os.fspath(path)
    _write_doc(path, {"version": CACHE_VERSION, "library": __version__, "entries": entries})
    _STATS["saves"] += 1
    telemetry.record_event("autotune_cache", action="save", path=path, entries=len(entries))
    return len(entries)


def _finite(t):
    if t is None:
        return None
    t = float(t)
    return t if t < 1e9 else 1e9


def _parse_cache_doc(doc):
    """Validate and parse one cache document (shared by :func:`load` and
    :func:`merge`): raises on anything :func:`load` refuses."""
    if not isinstance(doc, dict):
        raise ValueError("not a JSON object")
    if doc.get("version") != CACHE_VERSION:
        raise ValueError(f"cache version {doc.get('version')!r}, want {CACHE_VERSION}")
    if doc.get("library") != __version__:
        raise ValueError(f"library {doc.get('library')!r}, want {__version__!r}")
    parsed = []
    for ent in doc["entries"]:
        w = ent.get("winner")
        if w is not None and w not in _KNOWN_ARMS:
            raise ValueError(f"unknown arm {w!r}")
        arm_names = tuple(ent.get("arms", {})) or ARMS
        for a in arm_names:
            if a not in _KNOWN_ARMS:
                raise ValueError(f"unknown arm {a!r}")
        if w is not None and w not in arm_names:
            raise ValueError(f"winner {w!r} outside entry arms")
        parsed.append((
            (str(ent["fingerprint"]), str(ent["device_kind"])),
            w,
            ent.get("best_s"),
            str(ent.get("desc") or ""),
            {a: [float(t) for t in ent.get("arms", {}).get(a, [])] for a in arm_names},
        ))
    return parsed


def _read_doc(path: str, site: str):
    """The parsed entries of the cache at ``path``, or ``None`` after
    counting and recording a fallback."""
    try:
        with open(path) as f:
            doc = json.load(f)
        return _parse_cache_doc(doc)
    except Exception as exc:
        _STATS["fallbacks"] += 1
        telemetry.record_event("fallback", site=site, path=path, error=str(exc))
        return None


def load(path) -> int:
    """Restore a saved table.  A corrupt, stale-version or other-library
    file is ignored with a recorded ``fallback`` (a warm start never breaks
    a cold one); entries of another device kind load but never match a
    key here.  Returns the number of entries restored (0 on fallback)."""
    path = os.fspath(path)
    parsed = _read_doc(path, "autotune.load")
    if parsed is None:
        return 0
    for key, w, best, desc, arms in parsed:
        e = _entry(key, desc)
        e["winner"] = w
        e["best_s"] = float(best) if best is not None else None
        e["arms"] = arms
        e["strikes"] = 0
        e["loaded"] = True
    _STATS["cache_loads"] += len(parsed)
    _GENERATION[0] += 1
    telemetry.record_event("autotune_cache", action="load", path=path, entries=len(parsed))
    return len(parsed)


def _merge_prefers(new: dict, old: dict) -> bool:
    """Newest-best: a resolved winner beats an unresolved entry; between
    resolved entries the lower ``best_s`` wins; a tie goes to ``new``."""
    nw, ow = new["winner"], old["winner"]
    if (nw is None) != (ow is None):
        return nw is not None
    nb, ob = new["best_s"], old["best_s"]
    if nw is not None and nb is not None and ob is not None and nb != ob:
        return nb < ob
    return True


def merge(paths, out) -> str:
    """Merge several processes' caches into one warm-start file, newest-best
    per (fingerprint, device kind, arm set).  A file :func:`load` would
    refuse is skipped whole with a recorded ``fallback``.  Written
    atomically in :func:`save`'s format; returns ``out``.  Also
    ``python -m heat_tpu_torch.core.autotune --merge IN... --out OUT``."""
    chosen: Dict[tuple, dict] = {}
    sources = 0
    for path in paths:
        path = os.fspath(path)
        parsed = _read_doc(path, "autotune.merge")
        if parsed is None:
            continue
        sources += 1
        for key, w, best, desc, arms in parsed:
            entry = {
                "fingerprint": key[0],
                "device_kind": key[1],
                "winner": w,
                "best_s": _finite(float(best)) if best is not None else None,
                "desc": desc,
                "arms": {a: [_finite(t) for t in d] for a, d in arms.items()},
            }
            mkey = key + (tuple(sorted(arms)),)
            old = chosen.get(mkey)
            if old is None or _merge_prefers(entry, old):
                chosen[mkey] = entry
    doc = {
        "version": CACHE_VERSION,
        "library": __version__,
        "entries": sorted(chosen.values(), key=lambda e: (e["fingerprint"], e["device_kind"])),
    }
    out = os.fspath(out)
    _write_doc(out, doc)
    telemetry.record_event("autotune_cache", action="merge", path=out, entries=len(chosen), sources=sources)
    return out


def _init_from_env() -> None:
    """Warm start at import: ``HEAT_TPU_AUTOTUNE_CACHE=<path>`` loads the
    table (a missing file is a fresh start, not a fallback).  There is no
    compilation cache to enable beside it: the CUDA builds are cached by
    ``ops/_build.py``."""
    path = os.environ.get("HEAT_TPU_AUTOTUNE_CACHE", "").strip()
    if path and enabled() and os.path.exists(path):
        load(path)


# ------------------------------------------------------------------- report


def report(top: Optional[int] = None) -> dict:
    """The table as a dashboard dict: the header (device kind, enabled,
    generation, counters) and one row per entry, resolved winners first,
    then by fingerprint.  Each row has ``<arm>_min_s`` and
    ``<arm>_samples`` for its own arms."""
    rows = []
    for (fp, dk), e in _TABLE.items():
        row = {
            "fingerprint": fp,
            "device_kind": dk,
            "desc": e["desc"],
            "winner": e["winner"],
            "source": "cached" if e["loaded"] else "explored" if e["winner"] else "prior",
            "best_s": _finite(e["best_s"]),
            "arms": tuple(e["arms"]),
        }
        row.update(_arm_times(e))
        for a, d in e["arms"].items():
            row[a + "_samples"] = len(d)
        rows.append(row)
    rows.sort(key=lambda r: (r["winner"] is None, r["fingerprint"]))
    if top is not None:
        rows = rows[: int(top)]
    return {
        "device_kind": device_kind(),
        "enabled": enabled(),
        "generation": _GENERATION[0],
        "stats": stats(),
        "rows": rows,
    }


_init_from_env()


# ---------------------------------------------------------------------- CLI


def _main(argv=None) -> int:
    """``python -m heat_tpu_torch.core.autotune --merge IN [IN ...] --out
    OUT``: merge caches from the shell."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.core.autotune",
        description="Merge per-process tuning caches into one warm-start file.",
    )
    parser.add_argument("--merge", nargs="+", metavar="IN", required=True,
                        help="input cache files (later files win ties: newest last)")
    parser.add_argument("--out", metavar="OUT", required=True, help="merged output path")
    opts = parser.parse_args(argv)
    out = merge(opts.merge, opts.out)
    with open(out) as f:
        entries = len(json.load(f)["entries"])
    print(f"merged {len(opts.merge)} cache(s) -> {out} ({entries} entries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
