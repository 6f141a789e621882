"""Roofline attribution: measured program time against the card's peaks
(counterpart of heat_tpu/core/roofline.py).

The program ledger (``telemetry.programs()``) holds each program's
predicted work (a kernel site's operations and bytes) and its measured
wall clocks.  This module turns them into achieved GFLOP/s and GB/s, the
shares of the compute and memory rooflines, and a compute- or memory-bound
verdict per program.

The peaks come from ``torch.cuda.get_device_properties`` matched against a
table of cards (the H100; no TPU table), or from ``HEAT_TPU_PEAKS`` as
``k=v`` pairs or a JSON object::

    HEAT_TPU_PEAKS="bf16_tflops=989,f32_tflops=67,hbm_gbps=3350"

(``f32_tflops`` defaults to a quarter of ``bf16_tflops``, heat_tpu's
rule).  Honesty rule: on the CPU, or a card the table does not know, the
peaks are unknown: the report still shows measured time and achieved
rates, but the roofline fractions are ``None`` and the verdict is
``"unknown-peak"``, never a share of a made-up peak.

The verdict is structural: with known peaks a program whose predicted
bytes take longer at peak bandwidth than its predicted operations at peak
compute is memory-bound, whatever its measured time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["attribute", "detect_peaks", "render", "report"]

# Published dense peaks (NVIDIA's data sheet, no sparsity, at the full
# power limit) by card, matched as lowercase substrings of the device name:
# (name, bf16 TFLOP/s, f32 TFLOP/s outside the tensor cores, HBM GB/s).
# Other cards (an H100 PCIe or NVL among them) are unknown.
_KNOWN = (
    ("h100 80gb hbm3", 989.0, 67.0, 3350.0),  # H100 SXM5, 700 W
    ("h100 sxm", 989.0, 67.0, 3350.0),
)

# dtypes that run the tensor cores at the half-precision rate
_HALF_DTYPES = frozenset(("bfloat16", "float16", "torch.bfloat16", "torch.float16"))


def _parse_env(raw: str) -> Optional[Dict[str, float]]:
    raw = raw.strip()
    if not raw:
        return None
    try:
        if raw.startswith("{"):
            kv = json.loads(raw)
        else:
            kv = {}
            for part in raw.replace(";", ",").split(","):
                if not part.strip():
                    continue
                k, _, v = part.partition("=")
                kv[k.strip()] = v
        return {str(k): float(v) for k, v in kv.items()}
    except (ValueError, TypeError):
        return None


def _device_name() -> str:
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return str(torch.cuda.get_device_properties(torch.cuda.current_device()).name)


def detect_peaks() -> Dict[str, Any]:
    """The active device's peak table: ``{"device", "known",
    "bf16_tflops", "f32_tflops", "hbm_gbps", "source"}``.  ``source`` is
    ``env`` (the ``HEAT_TPU_PEAKS`` override), ``detected`` (the card's
    name matched the table) or ``unknown`` (the CPU, or an unknown card:
    ``known`` False, every peak ``None``).  Peaks are the published ones at
    the card's full power limit."""
    kind = _device_name()
    env = _parse_env(os.environ.get("HEAT_TPU_PEAKS", ""))
    if env is not None:
        bf16 = env.get("bf16_tflops")
        f32 = env.get("f32_tflops", bf16 / 4.0 if bf16 else None)
        hbm = env.get("hbm_gbps")
        return {
            "device": kind,
            "known": bool(bf16 or f32 or hbm),
            "bf16_tflops": bf16,
            "f32_tflops": f32,
            "hbm_gbps": hbm,
            "source": "env",
        }
    low = kind.lower()
    for sub, bf16, f32, hbm in _KNOWN:
        if sub in low:
            return {
                "device": kind,
                "known": True,
                "bf16_tflops": bf16,
                "f32_tflops": f32,
                "hbm_gbps": hbm,
                "source": "detected",
            }
    return {
        "device": kind,
        "known": False,
        "bf16_tflops": None,
        "f32_tflops": None,
        "hbm_gbps": None,
        "source": "unknown",
    }


def _flops_peak(peaks: dict, dtype) -> Optional[float]:
    """Peak FLOP/s for a program's compute dtype (f32 when unrecorded —
    the conservative full-precision rate)."""
    name = str(dtype)
    key = "bf16_tflops" if name in _HALF_DTYPES else "f32_tflops"
    got = peaks.get(key)
    return got * 1e12 if got else None


def attribute(entry: dict, peaks: Optional[dict] = None) -> Optional[dict]:
    """One roofline row for a ledgered program — or ``None`` when the
    program has no measured executions yet (predicted cost alone can't
    place it on the roofline)."""
    if peaks is None:
        peaks = detect_peaks()
    calls = entry.get("calls", 0)
    min_s = entry.get("min_s")
    if not calls or not min_s or min_s <= 0:
        return None
    flops = float(entry.get("flops") or 0.0)
    hbm = float(entry.get("hbm_bytes") or 0.0)
    # best-sustained rates: min over the sampled walls (standard roofline
    # practice — the slower samples carry dispatch/interference noise,
    # and the per-program p50 is reported alongside for honesty)
    gflops = flops / min_s / 1e9
    gbps = hbm / min_s / 1e9
    peak_flops = _flops_peak(peaks, entry.get("dtype", "float32"))
    hbm_gbps = peaks.get("hbm_gbps")
    peak_bw = hbm_gbps * 1e9 if hbm_gbps else None
    frac_c = gflops * 1e9 / peak_flops if peak_flops and flops else None
    frac_h = gbps * 1e9 / peak_bw if peak_bw and hbm else None
    if not peaks.get("known"):
        verdict = "unknown-peak"
    else:
        t_compute = flops / peak_flops if peak_flops else 0.0
        t_hbm = hbm / peak_bw if peak_bw else 0.0
        if t_compute == 0.0 and t_hbm == 0.0:
            verdict = "unknown-peak"  # no predicted work on either axis
        else:
            verdict = "memory-bound" if t_hbm >= t_compute else "compute-bound"
    # host-I/O axis: a streaming program may carry the measured fraction
    # of its wall spent blocked on host reads; that observation overrides
    # the structural verdict
    io_stall = entry.get("io_stall_frac")
    if io_stall is not None and io_stall >= 0.5:
        verdict = "io-bound"
    # the memory axis (memtrack readings folded in by timed_call): measured
    # peak residency against the predicted bytes
    peak_bytes = entry.get("peak_bytes")
    amp = round(peak_bytes / hbm, 3) if peak_bytes and hbm else None
    # wire axis (heat_tpu's core/wire.py, not ported yet): an entry that
    # ships a quantized collective carries its logical and wire bytes
    wire = entry.get("wire")
    w_logical = float(entry.get("logical_bytes") or 0.0)
    w_wire = float(entry.get("wire_bytes") or 0.0)
    wire_ratio = round(w_logical / w_wire, 2) if wire and w_wire else None
    wire_flip = None
    if wire and peaks.get("known") and verdict != "unknown-peak" and peak_bw:
        t_compute_ = flops / peak_flops if peak_flops else 0.0
        v_c = "memory-bound" if (hbm + w_wire) / peak_bw >= t_compute_ else "compute-bound"
        v_u = "memory-bound" if (hbm + w_logical) / peak_bw >= t_compute_ else "compute-bound"
        wire_flip = v_c != v_u
    return {
        "fingerprint": entry["fingerprint"],
        "kind": entry.get("kind"),
        "calls": calls,
        "total_s": entry.get("total_s"),
        "p50_s": entry.get("p50_s"),
        "min_s": min_s,
        "flops": flops,
        "hbm_bytes": hbm,
        "achieved_gflops": round(gflops, 3),
        "achieved_gbps": round(gbps, 3),
        "frac_compute_roofline": round(frac_c, 4) if frac_c is not None else None,
        "frac_hbm_roofline": round(frac_h, 4) if frac_h is not None else None,
        "peak_bytes": peak_bytes,
        "mem_amplification": amp,
        "mem_source": entry.get("mem_source"),
        "verdict": verdict,
        "io_stall_frac": io_stall,
        "io_bytes": entry.get("io_bytes"),
        "mesh": entry.get("mesh"),
        "wire": wire,
        "wire_logical_bytes": w_logical if wire else None,
        "wire_bytes": w_wire if wire else None,
        "wire_ratio": wire_ratio,
        "wire_verdict_flip": wire_flip,
    }


def report(
    programs: List[dict],
    *,
    top: Optional[int] = None,
    peaks: Optional[dict] = None,
) -> dict:
    """The roofline document: ``{"device", "peaks", "rows",
    "memory_bound_tail"}``.  Rows cover every program with measured time,
    sorted by total measured seconds; ``memory_bound_tail`` lists the
    memory-bound fingerprints."""
    if peaks is None:
        peaks = detect_peaks()
    rows = [r for e in programs for r in (attribute(e, peaks),) if r is not None]
    rows.sort(key=lambda r: -(r["total_s"] or 0.0))
    if top is not None:
        rows = rows[: max(int(top), 0)]
    return {
        "device": peaks["device"],
        "peaks": peaks,
        "rows": rows,
        "memory_bound_tail": [
            r["fingerprint"] for r in rows if r["verdict"] == "memory-bound"
        ],
    }


def render(doc: Optional[dict] = None, top: Optional[int] = None) -> str:
    """Human-readable report table.  With no document, pulls
    ``telemetry.roofline_report(top=top)``."""
    if doc is None:
        from . import telemetry

        doc = telemetry.roofline_report(top=top)
    p = doc["peaks"]
    lines = [
        f"device={doc['device']} source={p['source']} "
        f"peaks: bf16={p['bf16_tflops']} TFLOP/s f32={p['f32_tflops']} "
        f"TFLOP/s hbm={p['hbm_gbps']} GB/s"
    ]
    lines.append(
        f"{'fingerprint':<14}{'kind':<20}{'calls':>6}{'total_s':>10}"
        f"{'p50_s':>10}{'GFLOP/s':>10}{'GB/s':>9}{'%comp':>7}{'%hbm':>7}"
        f"{'peakMB':>8}{'amp':>6}{'lgclMB':>9}{'wireMB':>8}{'wire_x':>7}"
        "  verdict"
    )
    for r in doc["rows"]:
        pc = f"{100 * r['frac_compute_roofline']:.1f}" if r["frac_compute_roofline"] is not None else "-"
        ph = f"{100 * r['frac_hbm_roofline']:.1f}" if r["frac_hbm_roofline"] is not None else "-"
        pk = f"{r['peak_bytes'] / 1e6:.1f}" if r.get("peak_bytes") else "-"
        am = f"{r['mem_amplification']:.2f}" if r.get("mem_amplification") else "-"
        if r.get("wire"):
            lg = f"{r['wire_logical_bytes'] / 1e6:.2f}"
            wi = f"{r['wire_bytes'] / 1e6:.2f}"
            wx = f"{r['wire_ratio']:.1f}" if r.get("wire_ratio") else "-"
        else:
            lg = wi = wx = "-"
        flip = " [wire-flip]" if r.get("wire_verdict_flip") else ""
        lines.append(
            f"{r['fingerprint']:<14}{(r['kind'] or ''):<20}{r['calls']:>6}"
            f"{r['total_s']:>10.4f}{r['p50_s']:>10.6f}"
            f"{r['achieved_gflops']:>10.2f}{r['achieved_gbps']:>9.2f}"
            f"{pc:>7}{ph:>7}{pk:>8}{am:>6}{lg:>9}{wi:>8}{wx:>7}"
            f"  {r['verdict']}{flip}"
        )
    if doc["memory_bound_tail"]:
        lines.append(
            "memory-bound tail: "
            + ", ".join(doc["memory_bound_tail"])
        )
    return "\n".join(lines)
