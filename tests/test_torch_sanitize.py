"""heat_tpu_torch's runtime sanitizer (``analysis/sanitize.py``) against
heat_tpu's on the CPU: the toggle, donated-tensor poisoning with its
weakref identity check, ``check_use`` at the transport entries, and the
collective-sequence fingerprint, which the same user operations must
leave equal in both packages (digest, count and trail) at meshes 4 and 8.
Every comparison is exact."""

import gc

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.analysis import sanitize as TS
from heat_tpu_torch.core import telemetry as TT


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JS(ht):
    from heat_tpu.analysis import sanitize

    return sanitize


@pytest.fixture
def live(JS):
    prev = (TS.set_enabled(True), JS.set_enabled(True))
    TS.reset()
    JS.reset()
    TT.reset_group("sanitize")
    yield
    TS.set_enabled(prev[0])
    JS.set_enabled(prev[1])
    TS.reset()
    JS.reset()


def test_toggle_parses_as_heat_tpus(JS, monkeypatch):
    for mod in (TS, JS):
        prev = mod.set_enabled(None)
        for raw, want in (("1", True), ("on", True), ("YES", True), ("", False), ("0", False), ("off", False)):
            monkeypatch.setenv("HEAT_TPU_SANITIZE", raw)
            assert mod.enabled() is want, raw
        assert mod.set_enabled(True) is None and mod.enabled()
        assert mod.set_enabled(prev) is True
    assert set(TS.__all__) <= set(dir(JS)) and TS._POISON_MAX == JS._POISON_MAX
    assert set(TT.snapshot()["sanitize"]) == {"poisoned", "checks", "use_after_donate", "collective_events"}


def test_poison_and_check_use_name_both_sites(live):
    prev = TT.set_level("events")
    TT.clear_events()
    try:
        t = htt.array(np.ones((4, 3), np.float32), device="cpu").shards[0]  # ledgered at its factory
        TS.poison(t, donated_site="probe.donate")
        entry = TS.poison_entry(t)
        assert entry["donated"] == "probe.donate" and entry["nbytes"] == 48 and entry["shape"] == (4, 3)
        assert "test_torch_sanitize.py" in entry["created"] and entry["dtype"] == "torch.float32"
        with pytest.raises(TS.UseAfterDonateError, match=r"use-after-donate in probe: this torch.float32\[4, 3\]"):
            TS.check_use([torch.zeros(1), t], "probe")
        assert TS._STATS["use_after_donate"] == 1 and TS._STATS["checks"] == 2
        (ev,) = [e for e in TT.events() if e["kind"] == "analysis_finding"]
        assert ev["rule"] == "use_after_donate" and ev["donated"] == "probe.donate"
        TS.check_use(torch.zeros(2), "probe")  # an innocent tensor passes
        TS.clear_poison()
        TS.check_use(t, "probe")
    finally:
        TT.set_level(prev)


def test_a_recycled_id_never_convicts_a_new_tensor(live):
    old = torch.ones(3)
    TS.poison(old)
    entry = TS._POISON.pop(id(old))
    new = torch.ones(3)
    # the record of a dead tensor whose id the allocator handed to ``new``
    TS._POISON[id(new)] = entry
    del old
    gc.collect()
    assert TS.poison_entry(new) is None and id(new) not in TS._POISON
    TS.check_use(new, "probe")


def test_bookkeeping_only_while_tracking(live):
    TS.set_enabled(False)
    t = torch.ones(2)
    TS.poison(t)
    assert TS.poison_entry(t) is None
    TS.register_interest(lambda: True)
    try:
        TS.poison(t)
        assert TS.poison_entry(t) is not None
        TS.check_use(t, "probe")  # the raising sanitizer is off
    finally:
        TS._AUX_INTEREST.clear()
    # the ledger is bounded
    TS.set_enabled(True)
    keep = [torch.zeros(1) for _ in range(TS._POISON_MAX + 5)]
    for k in keep:
        TS.poison(k)
    assert len(TS._POISON) == TS._POISON_MAX and TS.poison_entry(keep[0]) is None


def test_transport_entries_check_their_inputs(live):
    comm = htt.MeshComm(4)
    x = htt.array(np.arange(96, dtype=np.float32).reshape(12, 8), split=0, comm=comm, device="cpu")
    TS.poison(x.shards[2], donated_site="probe.donate")
    with pytest.raises(TS.UseAfterDonateError, match="transport.tiled_resplit"):
        htt.resplit(x, 1)
    with pytest.raises(TS.UseAfterDonateError, match="transport.tiled_reshape"):
        htt.reshape(x, (8, 12), new_split=1)
    TS.clear_poison()
    assert htt.resplit(x, 1).split == 1


@pytest.mark.parametrize("n", [4, 8])
def test_collective_fingerprint_equals_heat_tpus(ht, JS, live, n):
    from heat_tpu.core import wire as JW

    from heat_tpu_torch.core import wire as TW

    prev = (TW.set_mode("off"), JW.set_mode("off"))
    a = np.arange(24 * 10, dtype=np.float32).reshape(24, 10)
    try:
        out = []
        for pkg, comm, kw, mod in ((ht, ht.parallel.mesh.local_mesh(n), {}, JS),
                                   (htt, htt.MeshComm(n), {"device": "cpu"}, TS)):
            mod.reset_collective_fingerprint()
            x = pkg.array(a, split=0, comm=comm, **kw)
            y = pkg.resplit(x, 1)
            pkg.reshape(y, (12, 20), new_split=1)
            pkg.reshape(x, (20, 12), new_split=0)
            pkg.reshape(x, (24, 2, 5), new_split=0)  # split-preserving: no collective
            mod.collective_event("custom", axis="x", site="probe")
            out.append(mod.collective_fingerprint())
        assert out[0] == out[1]
        assert [t[1] for t in out[1]["trail"]] == ["resplit", "resplit", "reshape", "resplit", "reshape", "custom"]
    finally:
        TW.set_mode(prev[0])
        JW.set_mode(prev[1])
    TS.set_enabled(False)
    TS.collective_event("ignored")
    assert TS.collective_fingerprint()["n"] == 6
