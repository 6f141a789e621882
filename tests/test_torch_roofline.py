"""``heat_tpu_torch.core.roofline`` against heat_tpu's on the CPU: the
honest unknown-peak verdict, the ``HEAT_TPU_PEAKS`` override in both of
its forms, the verdict arithmetic of :func:`attribute`, the report and its
rendering, and the port's own peak table (the H100's, found through the
device name).  The mirror is ``tests/test_roofline.py``.

Exact agreement is required: the rows are the same arithmetic on the
same floats in both packages.
"""

import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.core import roofline as PR
from heat_tpu_torch.core import telemetry as PT


@pytest.fixture(scope="module")
def JR():
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    from heat_tpu.core import roofline

    return roofline


def _drop_device(peaks):
    return {k: v for k, v in peaks.items() if k != "device"}


@pytest.mark.parametrize("raw", [None, "bf16_tflops=197,hbm_gbps=819", "bf16_tflops=197;hbm_gbps=819",
                                 '{"bf16_tflops": 275, "f32_tflops": 68.75, "hbm_gbps": 1228}', "not=numbers=at-all",
                                 "hbm_gbps=3350", ""])
def test_peaks_match_on_the_cpu(JR, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HEAT_TPU_PEAKS", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_PEAKS", raw)
    got, want = PR.detect_peaks(), JR.detect_peaks()
    assert _drop_device(got) == _drop_device(want)
    assert got["device"] == "cpu"
    if raw in (None, "", "not=numbers=at-all"):
        assert got["known"] is False and got["source"] == "unknown" and got["bf16_tflops"] is None


@pytest.mark.parametrize("name, known", [("NVIDIA H100 80GB HBM3", True), ("NVIDIA H100 PCIe", False),
                                         ("NVIDIA A100-SXM4-80GB", False)])
def test_the_card_table_names_the_h100(monkeypatch, name, known):
    monkeypatch.delenv("HEAT_TPU_PEAKS", raising=False)
    monkeypatch.setattr(PR, "_device_name", lambda: name)
    peaks = PR.detect_peaks()
    assert peaks["device"] == name and peaks["known"] is known
    if known:
        assert (peaks["bf16_tflops"], peaks["f32_tflops"], peaks["hbm_gbps"], peaks["source"]) == (
            989.0, 67.0, 3350.0, "detected")


PEAKS = {"device": "x", "known": True, "bf16_tflops": 197.0, "f32_tflops": 49.25, "hbm_gbps": 819.0, "source": "env"}
ENTRIES = [
    {"fingerprint": "f1", "kind": "ring_matmul", "calls": 3, "total_s": 0.3, "p50_s": 0.1, "min_s": 0.1,
     "flops": 2.0 * 4096 ** 3, "hbm_bytes": 3 * 4096 ** 2 * 4.0},
    {"fingerprint": "f2", "kind": "transport_resplit", "calls": 1, "total_s": 0.01, "p50_s": 0.01, "min_s": 0.01,
     "flops": 0.0, "hbm_bytes": 1e9, "peak_bytes": 3e9, "mem_source": "device"},
    {"fingerprint": "f3", "kind": "kernel_cdist", "calls": 2, "total_s": 0.02, "p50_s": 0.01, "min_s": 0.01,
     "flops": 1e9, "hbm_bytes": 1e6, "dtype": "bfloat16", "io_stall_frac": 0.7},
    {"fingerprint": "f4", "kind": "program", "calls": 1, "total_s": 0.5, "p50_s": 0.5, "min_s": 0.5,
     "flops": None, "hbm_bytes": None},
    {"fingerprint": "f5", "flops": 1.0},
]


@pytest.mark.parametrize("peaks", [PEAKS, {**PEAKS, "known": False, "bf16_tflops": None, "f32_tflops": None,
                                           "hbm_gbps": None, "source": "unknown"}])
def test_attribution_and_report_match(JR, peaks):
    for e in ENTRIES:
        assert PR.attribute(e, peaks) == JR.attribute(e, peaks)
    got, want = PR.report(ENTRIES, peaks=peaks, top=3), JR.report(ENTRIES, peaks=peaks, top=3)
    assert got == want
    assert [r["fingerprint"] for r in got["rows"]] == ["f4", "f1", "f3"]
    if peaks["known"]:
        verdicts = {r["fingerprint"]: r["verdict"] for r in PR.report(ENTRIES, peaks=peaks)["rows"]}
        assert verdicts == {"f1": "compute-bound", "f2": "memory-bound", "f3": "io-bound", "f4": "unknown-peak"}
    assert PR.render(got).splitlines()[0] == JR.render(want).splitlines()[0]
    assert len(PR.render(got).splitlines()) == len(JR.render(want).splitlines())


def test_roofline_report_of_the_ledger_is_honest_on_the_cpu(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_PEAKS", raising=False)
    prev = PT.set_level("events")
    PT.reset_programs()
    try:
        PT.record_program("fpR", kind="kernel_probe", flops=4.0, hbm_bytes=8.0)
        for _ in range(3):
            PT.timed_call("fpR", lambda: sum(range(1000)))
        doc = PT.roofline_report()
        (row,) = doc["rows"]
        assert row["calls"] == 3 and row["verdict"] == "unknown-peak" and row["frac_compute_roofline"] is None
        assert row["p50_s"] >= row["min_s"] > 0 and doc["device"] == "cpu"
        assert "fpR" in PR.render(doc) and "fpR" in PR.render()
    finally:
        PT.set_level(prev)
        PT.reset_programs()
    assert htt.roofline is PR
