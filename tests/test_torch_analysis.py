"""``heat_tpu_torch.analysis``: the lint rules and the program auditor
(mirrors tests/test_analysis.py).

Lint: HT001, HT003 and HT004 find the same codes on the same lines as
heat_tpu's lint on snippets that mean the same in both packages; HT002 and
HT005 are held to their torch forms; suppression, line-drift-stable
identities, the baseline round trip, and ``--check`` over the shipped
``heat_tpu_torch/`` tree with its baseline.  Audit: every rule on one small
program at mesh 4, the once-per-fingerprint watch, the engine sites (a
fused chain, a split-crossing resplit, a ring matmul) clean, and
``audited_dirty`` in ``roofline_report``.
"""

import io
import json
import textwrap

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.analysis import lint as L
from heat_tpu_torch.analysis import program_audit as A
from heat_tpu_torch.analysis import sanitize as S
from heat_tpu_torch.core import fusion as PF
from heat_tpu_torch.core import quantize as TQ
from heat_tpu_torch.core import telemetry as TT
from heat_tpu_torch.parallel import collectives as C
from heat_tpu_torch.parallel import overlap as PO


@pytest.fixture(scope="module")
def JL():
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    from heat_tpu.analysis import lint

    return lint


@pytest.fixture
def audit():
    prev = A.set_mode("jaxpr")
    A.reset()
    S.clear_poison()
    yield
    A.set_mode(prev)
    A.reset()
    S.clear_poison()


def _codes(lint, src):
    return [(f.code, f.line) for f in lint.lint_source(textwrap.dedent(src))]


# ------------------------------------------------------------------ lint

SHARED = {
    "HT001": """
        import os
        def budget():
            a = int(os.environ["HEAT_TPU_TILE_BYTES"])
            b = float(os.environ.get("X", "1.5"))
            c = os.environ.get("Y", "on")
            return a, b, c
    """,
    "HT003": """
        def step(x, ht):
            if x.larray.sum() > 0:
                x = ht.resplit(x, 1)
            while x.larray.max() > 1:
                x = psum(x)
            if x.shape[0] > 4:
                x = all_gather(x)
            return x
    """,
    "HT004": """
        _COUNTS = {"a": 0, "b": 0}
        _OK = telemetry.register_group("ok", {"a": 0})
        def bump():
            _COUNTS["a"] += 1
            _COUNTS["b"] += 1
            _OK["a"] += 1
    """,
}


@pytest.mark.parametrize("code", sorted(SHARED))
def test_shared_rules_match_heat_tpu(JL, code):
    got = _codes(L, SHARED[code])
    assert got == _codes(JL, SHARED[code])
    assert got and {c for c, _ in got} == {code}


def test_ht002_torch_forms():
    src = """
        import torch
        def loop(x, t, telemetry, fp):
            a = x.larray.sum().item()
            torch.cuda.synchronize()
            h = x.larray.cpu()
            n = t.numpy()
            lst = torch.nonzero(t).tolist()
            s = float(torch.sum(t))
            ok = bool(x.larray.any())
            rows = int(t.shape[0])
            k = int(t.numel())
            q = telemetry.timed_call(fp, lambda: x.larray.sum().item())
            return a, h, n, lst, s, ok, rows, k, q
    """
    got = _codes(L, src)
    assert got == [("HT002", 4), ("HT002", 5), ("HT002", 6), ("HT002", 8), ("HT002", 9), ("HT002", 10)]


def test_ht005_quantize_donate():
    fires = """
        def serve(x, w, ht):
            qw = ht.quantize.quantize_weights(w, "int8", donate=True)
            return x @ qw, w.shape
    """
    assert _codes(L, fires) == [("HT005", 4)]
    quiet = """
        def serve(x, w, ht):
            qw = ht.quantize.quantize_weights(w, "int8", donate=True)
            w = None
            keep = ht.quantize.quantize_weights(x, "int8")
            return qw, keep, x
    """
    assert _codes(L, quiet) == []


def test_suppression_syntax_error_and_stable_identity():
    src = "def f(t):\n    return t.item()  # ht: HT002 ok — one scalar at the end of a fit\n"
    assert L.lint_source(src) == []
    assert [f.code for f in L.lint_source("def f(:\n")] == ["HT000"]
    base = "def f(t):\n    return t.item()\n"
    one = L.lint_source(base, relpath="m.py")
    two = L.lint_source("import os\n\n" + base, relpath="m.py")
    assert one[0].identity == two[0].identity and one[0].line + 2 == two[0].line


def test_baseline_round_trip(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("def f(t):\n    return t.item()\n")
    base = tmp_path / "baseline.json"
    found = L.lint_paths([str(src)])
    L.save_baseline(found, str(base))
    out = io.StringIO()
    assert L.check([str(src)], str(base), out=out) == 1 and "without justification" in out.getvalue()
    doc = json.loads(base.read_text())
    doc["findings"][0]["reason"] = "a test fixture"
    base.write_text(json.dumps(doc))
    assert L.check([str(src)], str(base), out=io.StringIO()) == 0


def test_the_port_checks_clean_against_its_baseline():
    out = io.StringIO()
    assert L.check(out=out) == 0, out.getvalue()
    entries = L.load_baseline()
    assert all(str(e.get("reason", "")).strip() and not e["reason"].startswith("TODO") for e in entries)


# ----------------------------------------------------------------- audit

def test_mode_parsing_and_override(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_AUDIT", "1")
    prev = A.set_mode(None)
    try:
        assert A.mode() == "jaxpr" and A.enabled()
        monkeypatch.setenv("HEAT_TPU_AUDIT", "hlo")
        assert A.mode() == "hlo"
        monkeypatch.setenv("HEAT_TPU_AUDIT", "off")
        assert A.mode() == "off" and not A.enabled()
        with pytest.raises(ValueError):
            A.set_mode("banana")
    finally:
        A.set_mode(prev)


def test_each_rule_on_one_program_at_mesh_4(audit):
    comm = htt.MeshComm(4)
    x = htt.array(np.arange(16, dtype=np.float32), split=0, comm=comm, device="cpu")

    def chatty(v):
        print_me = v.shards[0][0].item()
        return v * print_me

    assert [f["rule"] for f in A.audit_program("fixture", "fp-host", chatty, (x,), expect="any")] == ["host_transfer"]

    def reduce_all(v):
        return C.psum(v.shards)

    assert [f["rule"] for f in A.audit_program("fixture", "fp-coll", reduce_all, (x,), expect="none")] == [
        "unexpected_collective"]
    assert A.audit_program("fixture", "fp-coll-any", reduce_all, (x,), expect="any") == []
    # donated input matching no output
    got = A.audit_program("fixture", "fp-don", lambda v: v.shards[0][:2] * 1.0, (x,), donate=(0,))
    assert [f["rule"] for f in got] == ["donation_unaliasable"]
    # the reshard rule under hlo
    A.set_mode("hlo")
    got = A.audit_program("fixture", "fp-gather", lambda v: C.all_gather(v.shards), (x,), expect="reduce")
    assert [f["rule"] for f in got] == ["unexpected_reshard"]
    assert A.audit_program("fixture", "fp-sum", reduce_all, (x,), expect="reduce") == []


def test_use_after_donate_and_the_once_per_fingerprint_watch(audit):
    comm = htt.MeshComm(4)
    w = htt.array(np.ones((8, 4), np.float32), split=0, comm=comm, device="cpu")
    shards = list(w.shards)
    TQ.quantize_weights(w, "int8", axis=1, donate=True)
    del w
    audits0 = A._STATS["audits"]
    got = A.audit_program("fixture", "fp-d", lambda s: [t * 2 for t in s], (shards,))
    assert [f["rule"] for f in got] == ["use_after_donate"]
    got = A.audit_program("fixture", "fp-d", lambda s: [t * 2 for t in s], (shards,))
    assert [f["rule"] for f in got] == ["use_after_donate"] and A._STATS["audits"] == audits0 + 1


def test_engine_sites_audit_clean_and_dirty_rows_are_marked(audit):
    prev_level = TT.set_level("events")
    try:
        comm = htt.MeshComm(4)
        rng = np.random.default_rng(0)
        a = htt.array(rng.standard_normal((16, 12)).astype(np.float32), split=0, comm=comm, device="cpu")
        b = htt.array(rng.standard_normal((12, 8)).astype(np.float32), split=0, comm=comm, device="cpu")
        PF.reset_cache()
        (htt.exp(a * 0.5) + 1.0).sum().numpy()
        htt.resplit(a, 1).numpy()
        PO.set_mode("ring")
        with PF.fuse(False):
            htt.matmul(a, b).numpy()
        assert PO.stats()["last"]["schedule"] == "ring_ag"
        kinds = {k for k, _ in A._SEEN}
        assert {"fused", "ring_ag"} <= kinds and any(k.startswith("transport_") for k in kinds)
        assert A.findings() == []
        # a program with a host read: one finding, its roofline row dirty
        fp = TT.fingerprint(("audit-probe",))
        TT.record_program(fp, kind="probe", ops=1)
        prog = A.watched("probe", fp, lambda t: t * float(t.sum().item()), expect="none")
        TT.timed_call(fp, prog, a.shards[0])
        assert [f["rule"] for f in A.findings()] == ["host_transfer"]
        rows = {r["fingerprint"]: r for r in TT.roofline_report()["rows"]}
        assert rows[fp].get("audited_dirty") is True
        assert not any(r.get("audited_dirty") for f, r in rows.items() if f != fp)
    finally:
        PO.set_mode(None)
        PO.reset_stats()
        TT.set_level(prev_level)
