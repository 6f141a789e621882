"""Parity of heat_tpu_torch's tuning plane (``core/autotune.py``) with
heat_tpu's on the CPU (mirrors tests/test_autotune.py).

No test depends on which arm wins by wall clock: both packages' tables are
driven with the same ``observe`` sequence or the same cache document, and
every comparison is exact (the tables hold the numbers they were given).
The suite runs with ``HEAT_TPU_AUTOTUNE=off`` (the conftest default); each
test turns the plane on in both packages through the API and restores it.

The kernel sites K4-K7 keep a one-arm ``("kernel",)`` row on a CUDA tensor;
here the site's device check (``autotune.site_tunes``) is mocked so the CPU
path walks the site, and a cache that names ``"classic"`` for a kernel key
changes nothing on the path: the kernel's wrapper runs every call."""

import importlib
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import autotune as TA
from heat_tpu_torch.core import telemetry as TT

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JA(ht):
    from heat_tpu.core import autotune

    return autotune


@contextmanager
def _tuned(*mods, level="events"):
    """The tuning plane on in each autotune module, events level, clean
    tables and counters; restored on the way out."""
    tels = [importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".telemetry") for m in mods]
    prev = [(t.set_level(level), m.set_enabled(True)) for m, t in zip(mods, tels)]
    for m, t in zip(mods, tels):
        t.reset_all()
        t.clear_events()
        m.reset()
    try:
        yield
    finally:
        for m, t, (lvl, on) in zip(mods, tels, prev):
            m.set_enabled(on)
            m.reset()
            t.reset_all()
            t.clear_events()
            t.set_level(lvl)


def _counters(stats):
    return {k: v for k, v in stats.items() if k not in ("enabled", "table_size", "resolved", "generation")}


# ------------------------------------------------------------ keys and knobs
GEOMETRIES = [
    ("kernel_key", ("qr_panel", 4096, 128, "float32", True, 4)),
    ("kernel_key", ("lasso_sweep", 500000, 1001, "float32", 1)),
    ("kernel_key", ("reshape_repack", (64, 32), 0, (32, 64), 1, 4, "float32")),
    ("spmv_key", ("spmv_csr", 1000, 1000, 1, 14, 5000, 128, "float32", 4)),
    ("quant_key", ("moe_ffn", 16384, 512, 2048, 8, 4, 2, "int8")),
    ("quant_key", ("linear", 64, 32, 16, 4, "float32", 0, None, 0, "float8_e4m3fn")),
    ("wire_key", ("resplit", (16384, 4096), 0, 1, 4, "float32")),
    ("wire_key", ("rechunk", (64, 32), (32, 64), 4, "float32")),
    ("matmul_key", ("ab", 0, 8, 8, 8, 4, "float32")),
    ("stream_key", ("kmeans_fit", 1000, 8, "float32", 4, 20)),
]


@pytest.mark.parametrize("name, geometry", GEOMETRIES, ids=[f"{n}-{g[0]}" for n, g in GEOMETRIES])
def test_key_fingerprints_equal_heat_tpus(JA, name, geometry):
    # fingerprint parity: the port spells each geometry as heat_tpu does
    # (dtypes as "float32"); the device kinds differ by design
    assert getattr(TA, name)(*geometry)[0] == getattr(JA, name)(*geometry)[0]
    assert TA.kernel_key("qr_panel", 8, 8, "float32", True, 1)[1] == TA.device_kind()
    assert TA.device_kind() == ("gpu:" + torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu:cpu")


def test_arm_sets_and_counter_keys(JA):
    for name in ("ARMS", "KERNEL_ARMS", "QUANT_ARMS", "WIRE_ARMS", "SPMV_ARMS", "STREAM_ARMS", "CACHE_VERSION",
                 "_MAX_SAMPLES", "_DEGRADE_FACTOR", "_DEGRADE_STRIKES"):
        assert getattr(TA, name) == getattr(JA, name), name
    assert TA._KNOWN_ARMS == JA._KNOWN_ARMS
    assert set(TA.stats()) == set(JA.stats())
    assert set(TA.__all__) - {"dtype_name", "kernel_site", "site_tunes", "timed"} <= set(JA.__all__)


def test_env_parsers_raise_naming_the_variable(JA, monkeypatch):
    for mod in (TA, JA):
        assert mod.env_bytes("HEAT_X", 7, env={}) == 7
        assert mod.env_bytes("HEAT_X", 7, env={"HEAT_X": " 4096 "}) == 4096
        for bad in ("0", "-3", "1e3", "lots"):
            with pytest.raises(ValueError, match="HEAT_X must be a positive integer"):
                mod.env_bytes("HEAT_X", 7, env={"HEAT_X": bad})
        monkeypatch.setenv("HEAT_TPU_AUTOTUNE_EXPLORE", "5")
        assert mod.explore_k() == 5
        for bad in ("0", "two"):
            monkeypatch.setenv("HEAT_TPU_AUTOTUNE_EXPLORE", bad)
            with pytest.raises(ValueError, match="HEAT_TPU_AUTOTUNE_EXPLORE"):
                mod.explore_k()
        monkeypatch.delenv("HEAT_TPU_AUTOTUNE_EXPLORE")
        assert mod.explore_k() == 3
        prev = mod.set_enabled(None)
        for raw, want in (("off", False), ("0", False), ("no", False), ("on", True), ("", True), ("1", True)):
            monkeypatch.setenv("HEAT_TPU_AUTOTUNE", raw)
            assert mod.enabled() is want, raw
        mod.set_enabled(prev)


# --------------------------------------------------------- explore/exploit
SEQUENCES = {
    # (arm, seconds) in order; both arms reach explore_k = 3 samples
    "ring_wins": [("ring", 0.5), ("gspmd", 0.2), ("ring", 0.1), ("gspmd", 0.3), ("ring", 0.4), ("gspmd", 0.25)],
    "gspmd_wins": [("gspmd", 0.05), ("ring", 0.1), ("gspmd", 0.5), ("ring", 0.2), ("gspmd", 0.5), ("ring", 0.3)],
    "tie_to_first_arm": [("ring", 0.1), ("gspmd", 0.1)] * 3,
}


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_explore_resolves_by_min_s(JA, seq):
    with _tuned(TA, JA):
        rows = []
        for mod in (TA, JA):
            key = ("fp-" + seq, mod.device_kind())
            decisions = []
            for i, (arm, dur) in enumerate(SEQUENCES[seq]):
                if i % 2 == 0:
                    d = mod.decide(key, "gspmd", desc="mm")
                    decisions.append((d.arm, d.source, d.explore))
                mod.observe(key, arm, dur)
            d = mod.decide(key, "gspmd")
            decisions.append((d.arm, d.source, d.explore))
            entry = mod.table()[key]
            rep = mod.report()["rows"][0]
            rep.pop("device_kind")
            rows.append((decisions, entry["winner"], entry["best_s"], entry["arms"], rep, _counters(mod.stats()),
                         mod.winner(key)))
        assert rows[0] == rows[1]
        assert rows[0][1] == min(("ring", "gspmd"), key=lambda a: min(d for x, d in SEQUENCES[seq] if x == a))


def test_degradation_watch_and_sample_window(JA):
    with _tuned(TA, JA):
        out = []
        for mod in (TA, JA):
            key = ("fp-degrade", mod.device_kind())
            mod.decide(key, "classic", arms=mod.KERNEL_ARMS)
            for _ in range(3):
                mod.observe(key, "classic", 0.2)
                mod.observe(key, "kernel", 0.1)
            trail = []
            gen0 = mod.stats()["generation"]
            # one slow sample is noise, a fast one clears the strike; two
            # slow ones in a row send the winner back to explore
            for dur in (0.25, 0.5, 0.1, 0.21, 0.3, 0.9, 0.01):
                mod.observe(key, "kernel", dur)
                e = mod.table()[key]
                trail.append((e["winner"], e["strikes"], e["best_s"], {a: len(d) for a, d in e["arms"].items()}))
            # a sample of a losing arm never touches a resolved entry
            mod.observe(key, "classic", 5.0)
            e = mod.table()[key]
            # an arm's window keeps its newest _MAX_SAMPLES
            other = ("fp-window", mod.device_kind())
            mod.decide(other, "ring")
            for i in range(40):
                mod.observe(other, "ring", 1.0 + i)
            out.append((trail, mod.stats()["re_explores"], mod.stats()["generation"] - gen0, e["arms"],
                        mod.table()[other]["arms"]["ring"]))
        assert out[0] == out[1]
        assert out[0][1] == 1 and out[0][4] == [25.0 + i for i in range(TA._MAX_SAMPLES)]


def test_note_prior_winner_and_decision_events(JA):
    with _tuned(TA, JA):
        got = []
        for mod, tel in ((TA, TT), (JA, importlib.import_module("heat_tpu.core.telemetry"))):
            key = ("fp-prior", mod.device_kind())
            mod.note_prior(key, "wire_f32", site="wire_resplit")
            assert mod.winner(key) is None
            mod.decide(key, "bf16", arms=mod.QUANT_ARMS)
            for _ in range(3):
                mod.observe(key, "bf16", 0.3)
                mod.observe(key, "int8", 0.2)
            assert mod.winner(key) == "int8"
            kinds = [(e["kind"], e.get("source"), e.get("arm")) for e in tel.events()
                     if e["kind"].startswith("autotune")]
            got.append((kinds, _counters(mod.stats())))
        assert got[0] == got[1]


# ---------------------------------------------------------------- persistence
def _doc(lib, entries):
    return {"version": 1, "library": lib, "entries": entries}


def _entry(fp, dk, winner, best, arms):
    return {"fingerprint": fp, "device_kind": dk, "winner": winner, "best_s": best, "desc": "d", "arms": arms}


def test_save_load_documents_cross_between_the_packages(JA, tmp_path):
    with _tuned(TA, JA):
        key_t, key_j = ("fp-s", TA.device_kind()), ("fp-s", JA.device_kind())
        for mod, key in ((JA, key_j), (TA, key_t)):
            mod.decide(key, "wire_f32", desc="wire", arms=mod.WIRE_ARMS)
            for arm, dur in (("wire_f32", 0.3), ("wire_int8", 0.1), ("wire_fp8", 0.2)) * 3:
                mod.observe(key, arm, dur)
        JA.save(tmp_path / "j.json")
        TA.save(tmp_path / "t.json")
        dj, dt = json.loads((tmp_path / "j.json").read_text()), json.loads((tmp_path / "t.json").read_text())
        for e in dj["entries"] + dt["entries"]:
            e.pop("device_kind")
        assert dj == dt and TA.stats()["saves"] == 1
        # either package loads the other's document
        TA.reset()
        JA.reset()
        assert TA.load(tmp_path / "j.json") == 1 and JA.load(tmp_path / "t.json") == 1
        assert TA.table()[key_j]["winner"] == JA.table()[key_t]["winner"] == "wire_int8"
        assert TA.table()[key_j]["loaded"] and TA.stats()["cache_loads"] == 1


REFUSED = {
    "corrupt": "{nope",
    "version": json.dumps({"version": 2, "library": htt.__version__, "entries": []}),
    "library": json.dumps(_doc("9.9.9", [])),
    "unknown_winner": json.dumps(_doc(htt.__version__, [_entry("f", "cpu:cpu", "fast", 0.1, {"fast": [0.1]})])),
    "unknown_arm": json.dumps(_doc(htt.__version__, [_entry("f", "cpu:cpu", None, None, {"kernel": [], "warp": []})])),
    "winner_outside": json.dumps(_doc(htt.__version__, [_entry("f", "cpu:cpu", "ring", 0.1, {"bf16": [0.1]})])),
    "not_object": "[1, 2]",
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_load_refuses_and_counts_a_fallback(JA, tmp_path, case):
    path = tmp_path / "cache.json"
    path.write_text(REFUSED[case])
    with _tuned(TA, JA):
        for mod, tel in ((TA, TT), (JA, importlib.import_module("heat_tpu.core.telemetry"))):
            assert mod.load(path) == 0
            assert mod.stats()["fallbacks"] == 1 and mod.table() == {}
            (ev,) = [e for e in tel.events() if e["kind"] == "fallback"]
            assert ev["site"] == "autotune.load"


def test_merge_newest_best_and_refusals(JA, tmp_path):
    lib = htt.__version__
    a, b, bad, out_t, out_j = (tmp_path / n for n in ("a.json", "b.json", "bad.json", "t.json", "j.json"))
    a.write_text(json.dumps(_doc(lib, [
        _entry("fp_x", "cpu", "ring", 0.02, {"ring": [0.02], "gspmd": [0.05]}),
        _entry("fp_y", "cpu", None, None, {"classic": [0.5], "kernel": []}),
        _entry("fp_t", "cpu", "kernel", 0.1, {"kernel": [0.1]}),
    ])))
    b.write_text(json.dumps(_doc(lib, [
        _entry("fp_x", "cpu", "gspmd", 0.01, {"ring": [0.03], "gspmd": [0.01]}),
        _entry("fp_y", "cpu", "kernel", 0.1, {"classic": [0.5], "kernel": [0.1]}),
        {**_entry("fp_t", "cpu", "kernel", 0.1, {"kernel": [0.1]}), "desc": "newest"},
    ])))
    bad.write_text(json.dumps(_doc("9.9.9", [_entry("fp_z", "cpu", "ring", 0.001, {"ring": [0.001]})])))
    with _tuned(TA, JA):
        assert TA.merge([a, bad, b], out_t) == str(out_t)
        JA.merge([a, bad, b], out_j)
        doc = json.loads(out_t.read_text())
        assert doc == json.loads(out_j.read_text())
        got = {e["fingerprint"]: e for e in doc["entries"]}
        assert got["fp_x"]["winner"] == "gspmd" and got["fp_y"]["winner"] == "kernel"
        assert got["fp_t"]["desc"] == "newest" and "fp_z" not in got
        assert TA.stats()["fallbacks"] == JA.stats()["fallbacks"] == 1
        TA.reset()
        assert TA.load(out_t) == 3 and TA.winner(("fp_x", "cpu")) == "gspmd"


def test_merge_cli(tmp_path):
    a, out = tmp_path / "a.json", tmp_path / "m.json"
    a.write_text(json.dumps(_doc(htt.__version__, [_entry("fp", "cpu", "ring", 0.01, {"ring": [0.01]})])))
    run = subprocess.run([sys.executable, "-m", "heat_tpu_torch.core.autotune", "--merge", str(a), str(a), "--out",
                          str(out)], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr
    assert "merged 2 cache(s)" in run.stdout and "(1 entries)" in run.stdout
    assert len(json.loads(out.read_text())["entries"]) == 1
    bad = subprocess.run([sys.executable, "-m", "heat_tpu_torch.core.autotune", "--out", str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert bad.returncode == 2 and "--merge" in bad.stderr


def test_warm_start_loads_the_cache_at_import(tmp_path):
    """A fresh interpreter with ``HEAT_TPU_AUTOTUNE_CACHE`` serves the saved
    winner: zero explores."""
    with _tuned(TA):
        key = TA.quant_key("linear", 1, 2, 3)
        TA.decide(key, "bf16", arms=TA.QUANT_ARMS)
        for _ in range(3):
            TA.observe(key, "bf16", 0.2)
            TA.observe(key, "int8", 0.1)
        TA.save(tmp_path / "c.json")
    code = (
        "import heat_tpu_torch as ht\n"
        "k = ht.autotune.quant_key('linear', 1, 2, 3)\n"
        "d = ht.autotune.decide(k, 'bf16', arms=ht.autotune.QUANT_ARMS)\n"
        "s = ht.autotune.stats()\n"
        "print(d.arm, d.source, s['explores'], s['cache_loads'])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "HEAT_TPU_AUTOTUNE": "on",
           "HEAT_TPU_AUTOTUNE_CACHE": str(tmp_path / "c.json")}
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180, env=env)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["int8", "cached", "0", "1"]


def test_budget_seed_and_report_shape(JA):
    from heat_tpu_torch.core import memtrack
    from heat_tpu_torch.parallel import transport

    with _tuned(TA):
        # a statsless device keeps the static budget; a reporting one with
        # little free memory seeds a smaller one
        assert transport._plan_tile_budget("resplit") == transport.TILE_BYTES
        with memtrack.stats_override([{"bytes_in_use": 900 << 20, "bytes_limit": (900 << 20) + (8 << 20)}]):
            got = transport._plan_tile_budget("resplit")
        assert got == 2 << 20 and TA.stats()["budget_seeds"] == 1
        TA.note_staging_decline(("fp", "d"), 10, 5)
        assert TA.stats()["staging_declines"] == 1
        rep = htt.telemetry.autotune_report()
        assert set(rep) == set(JA.report()) and rep["stats"]["budget_seeds"] == 1


# ------------------------------------------------------------- kernel sites
def _count(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _run_sites():
    """QR (K4), Lasso (K5), the sparse product (K6) and a split-crossing
    reshape (K7's rechunk) on the CPU; returns their values."""
    rng = np.random.default_rng(3)
    comm = htt.MeshComm(4)
    x = htt.array(rng.standard_normal((64, 6)).astype(np.float32), device="cpu")
    q, r = htt.linalg.qr(x)
    y = htt.array(rng.standard_normal((64, 1)).astype(np.float32), device="cpu")
    lasso = htt.regression.Lasso(lam=0.01, max_iter=4).fit(x, y)
    theta = lasso.theta
    _run_sites.sweeps = lasso.n_iter
    a = htt.sparse.sparse_csr_matrix(np.eye(40, dtype=np.float32) * 2, split=0, comm=comm, device="cpu")
    v = htt.sparse.matmul(a, rng.standard_normal(40).astype(np.float32))
    z = htt.reshape(htt.array(np.arange(96, dtype=np.float32).reshape(12, 8), split=0, comm=comm, device="cpu"),
                    (8, 12), new_split=1)
    return [t.numpy() for t in (q, r, theta, v, z)]


@pytest.mark.parametrize("cache", ["none", "classic"])
def test_kernel_sites_launch_whatever_the_table_holds(monkeypatch, tmp_path, cache):
    from heat_tpu_torch.ops import lasso_sweep, qr_panel, repack, spmv

    want = _run_sites()  # the plane off: no table touched
    assert TA.table() == {}
    # counters level with no sampled call: the served calls feed no
    # observer, so no wall clock can send a row back to explore here
    with _tuned(TA, level="counters"):
        monkeypatch.setattr(TT, "_SAMPLE_EVERY", 1 << 30)
        monkeypatch.setattr(TA, "site_tunes", lambda t: True)
        if cache == "classic":
            # a cache whose kernel keys name heat_tpu's "classic" arm
            _run_sites()
            keys = [k for k, e in TA.table().items() if e["arms"] == {"kernel": e["arms"]["kernel"]}]
            assert len(keys) == 4
            (tmp_path / "c.json").write_text(json.dumps(_doc(htt.__version__, [
                {**_entry(fp, dk, "classic", 1e-9, {"classic": [1e-9], "kernel": [1.0]}), "desc": ""}
                for fp, dk in keys])))
            TA.reset()
            assert TA.load(tmp_path / "c.json") == 4
        counts = {name: _count(monkeypatch, mod, fn) for name, mod, fn in (
            ("K4", qr_panel, "fused_gram_chol"), ("K5", lasso_sweep, "sweep"), ("K6", spmv, "spmv"),
            ("K7", repack, "repack_segments"))}
        for _ in range(TA.explore_k() + 2):
            got = _run_sites()
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        n = TA.explore_k() + 2
        # K4: two passes a CholeskyQR2; K5: one a sweep; K6: one a position;
        # K7: one a destination position with rows
        assert len(counts["K4"]) == 2 * n and len(counts["K5"]) == _run_sites.sweeps * n
        assert len(counts["K6"]) == 4 * n and len(counts["K7"]) == 4 * n
        rows = {r["desc"].split()[0]: r for r in TA.report()["rows"]}
        assert set(rows) == {"qr", "lasso", "spmv", "reshape"}
        for r in rows.values():
            if cache == "classic":
                # the loaded "classic" winner is served and ignored
                assert r["winner"] == "classic" and r["source"] == "cached"
            else:
                assert r["arms"] == ("kernel",) and r["winner"] == "kernel" and r["kernel_samples"] == 3
                assert r["kernel_min_s"] is not None
