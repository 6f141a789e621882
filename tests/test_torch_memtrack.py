"""``heat_tpu_torch.core.memtrack`` (``ht.memtrack``) against heat_tpu's on
the CPU: the live-buffer ledger (gates, creation sites, lifetimes,
rebinds, tags, census and summary keys, ``memwatch``), the device readers
and the budget formula under ``stats_override`` (the CPU has no device
reader in either package), and the readings the ledger's programs carry.
The ledger holds the arrays of meshes 1, 4 and 8 by their shards.  The
mirror is ``tests/test_memtrack.py``.

Exact agreement is required throughout: every number here is an integer
count or a byte size.
"""

import gc
from contextlib import contextmanager

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.core import memtrack as PM
from heat_tpu_torch.core import telemetry as PT

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JM(ht):
    from heat_tpu.core import memtrack

    return memtrack


@contextmanager
def events(M):
    T = M.telemetry
    prev = T.set_level("events")
    M.reset()
    T.reset_programs()
    try:
        yield
    finally:
        T.set_level(prev)
        M.reset()
        T.reset_programs()
        T.clear_events()


def test_module_surface_matches(JM):
    assert set(JM.__all__) <= set(PM.__all__)
    assert PM.TAGS == JM.TAGS
    assert htt.memtrack is PM and htt.telemetry is PT


OVERRIDES = [
    [{"bytes_in_use": 900, "bytes_limit": 1000}],
    [{"bytes_in_use": 100, "bytes_limit": 1 << 20, "device": "a"}, {"bytes_in_use": 700, "bytes_limit": 800}],
    [{"bytes_in_use": None}],
]


@pytest.mark.parametrize("stats", OVERRIDES)
def test_device_readers_and_budget_under_an_override(JM, stats):
    got = []
    for M in (PM, JM):
        with M.stats_override(stats):
            got.append((
                M.device_bytes_in_use(), M.min_free_bytes(),
                M.suggest_budget(4096), M.suggest_budget(1 << 30, fraction=0.5, floor=16, headroom=10),
                M.would_fit(50), M.would_fit(10 ** 9, fraction=1.0),
            ))
    assert got[0] == got[1]


def test_statsless_cpu_reports_none(JM):
    for M in (PM, JM):
        assert M.device_bytes_in_use()[1] is None and M.min_free_bytes() is None
        assert M.suggest_budget(100) is None and M.would_fit(1) is None
        prev = M.telemetry.set_level("counters")
        try:
            assert M.sample_bytes() == (None, None)  # no ledger below events: an honest unknown
        finally:
            M.telemetry.set_level(prev)


@pytest.mark.parametrize("n", MESHES)
def test_factory_buffers_carry_this_files_site(ht, JM, n):
    rows = []
    for M, pkg, kw, comm in ((PM, htt, {"device": "cpu"}, htt.MeshComm(n)), (JM, ht, {}, None)):
        with events(M):
            if comm is None:
                comm = ht.parallel.mesh.local_mesh(n)
            x = pkg.zeros((64, 4), split=0, comm=comm, **kw)  # the line both entries name
            live = M.live_buffers(top=None)
            assert live and all(r["site"].startswith(__file__) for r in live)
            rows.append((sum(r["nbytes"] for r in live), {r["tag"] for r in live}, {r["split"] for r in live}))
            del x
    # the port ledgers each position's shard, heat_tpu the one global buffer
    assert rows[0] == rows[1] == (64 * 4 * 4, {"leaf"}, {0})


def test_entries_die_with_their_buffers_and_rewraps_are_rebinds(JM):
    for M, make, wrap in (
        (PM, lambda: htt.ones((32,), split=0, comm=htt.MeshComm(4), device="cpu"),
         lambda a: htt.DNDarray(a.shards, a.shape, a.dtype, a.split, a.device, a.comm)),
        (JM, None, None),
    ):
        if make is None:
            import heat_tpu as ht

            make = lambda: ht.ones((32,), split=0)  # noqa: E731
            wrap = lambda a: ht.DNDarray(a._DNDarray__array, a.gshape, a.dtype, a.split, a.device, a.comm)  # noqa: E731
        with events(M):
            a = make()
            n_live = M.summary()["live_buffers"]
            wrap(a)
            s = M.telemetry.snapshot_group("memtrack")
            assert s["live_buffers"] == n_live and s["rebinds"] >= 1
            del a
            gc.collect()
            s = M.telemetry.snapshot_group("memtrack")
            assert s["live_buffers"] == 0 and s["live_bytes"] == 0 and s["released"] == s["registered"]
            assert s["peak_live_bytes"] == 32 * 4


def test_gates_and_kill_switch(JM):
    for M in (PM, JM):
        T = M.telemetry
        for lvl in ("off", "counters"):
            prev = T.set_level(lvl)
            try:
                M.reset()
                keep = np.zeros(3)  # noqa: F841
                assert M.register_buffer(__import__("torch").zeros(3)) is None
                assert M.summary()["live_buffers"] == 0
            finally:
                T.set_level(prev)
        with events(M):
            was = M.set_enabled(False)
            try:
                import torch

                assert M.register_buffer(torch.zeros(3)) is None and M.sample_bytes() == (None, None)
            finally:
                M.set_enabled(was)


def test_summary_census_and_tags():
    import torch

    with events(PM):
        a = torch.zeros(10, dtype=torch.float32)
        b = torch.zeros(5, dtype=torch.float64)
        PM.register_buffer(a, tag="staging", split=0)
        PM.register_buffer(b)
        PM.tag_buffer(a, "pinned")
        PM.tag_buffer(a, "nonsense")  # an unknown tag is ignored
        s = PM.summary()
        assert s["bytes_by_tag"] == {"pinned": 40, "leaf": 40} and s["bytes_by_dtype"] == {"torch.float32": 40,
                                                                                          "torch.float64": 40}
        assert s["peak_bytes_by_tag"] == {"staging": 40, "leaf": 40, "pinned": 40}
        c = PM.census(top=1)
        assert c["live_buffers"] == 2 and c["live_bytes"] == 80 and len(c["top"]) == 1
        assert sorted(c["top"][0]) == ["age_s", "device", "dtype", "id", "nbytes", "pinned", "shape", "site", "split",
                                       "tag"]


def test_memtrack_group_and_census_keys_match(JM):
    for M in (PM, JM):
        with events(M):
            M.register_buffer(np.zeros(1) if M is JM else __import__("torch").zeros(1))
    assert sorted(PM.summary()) == sorted(JM.summary())
    assert sorted(PM.census()) == sorted(JM.census())


def test_memwatch_names_the_survivor(ht, JM):
    sites = []
    for M, pkg, kw in ((PM, htt, {"device": "cpu"}), (JM, ht, {})):
        with events(M):
            with M.memwatch() as w:
                scratch = pkg.zeros((4096,), split=0, **kw)
                keep = pkg.ones((8,), split=0, **kw)  # the survivor
                del scratch
            sites.append(sorted(r["site"].split(" in ")[0].rsplit(":", 1)[1] for r in w.retained))
            assert {r["kind"] for r in M.leaks()} == {"retained"}
            del keep
            gc.collect()
            assert M.leaks() == []
    assert sites[0] == sites[1] and len(sites[0]) >= 1


def test_readings_fold_into_the_ledger_under_an_override(JM):
    rows = []
    for M in (PM, JM):
        T = M.telemetry
        with events(M):
            with M.stats_override([{"bytes_in_use": 1234, "bytes_limit": 4096, "device": "d0"}]):
                T.record_program("fpM", kind="probe", flops=1.0, hbm_bytes=617.0)
                T.timed_call("fpM", lambda: None)
                (p,) = T.programs()
                rows.append((p["peak_bytes"], p["mem_source"], M.device_peaks(),
                             [e["bytes_in_use"] for e in T.events("mem_sample")],
                             T.snapshot_group("memtrack")["mem_samples"]))
            # no device reports: the ledger's live bytes, marked as such
            assert M.sample_bytes() == (0, "ledger")
    assert rows[0] == rows[1] == (1234, "device", {"d0": 1234}, [1234, 1234], 2)


def test_port_sites_ledger_shards_panels_and_slabs(tmp_path):
    import scipy.sparse

    comm = htt.MeshComm(4)
    with events(PM):
        x = htt.array(np.arange(48, dtype=np.float32).reshape(12, 4), split=0, comm=comm, device="cpu")
        x.resplit_(1)
        tags = PM.summary()["peak_bytes_by_tag"]
        assert tags["leaf"] == 48 * 4 and tags["donated"] == 48 * 4 and tags["output"] == 48 * 4
        a = htt.sparse.sparse_csr_matrix(scipy.sparse.random(16, 16, density=0.3, format="csr", dtype=np.float32,
                                                             random_state=0), split=0, comm=comm, device="cpu")
        htt.sparse.matmul(a, np.ones(16, np.float32))
        assert PM.summary()["bytes_by_tag"].get("staging", 0) > 0  # K6's repacking
        np.save(tmp_path / "d.npy", np.arange(40, dtype=np.float32).reshape(20, 2))
        prev = htt.get_device()
        htt.use_device("cpu")  # the loader's slabs land on the default device
        try:
            slabs = list(htt.utils.data.PartialH5Dataset(str(tmp_path / "d.npy"), comm=comm, initial_load=8))
        finally:
            htt.use_device(prev)
        assert [int(s.shape[0]) for s in slabs] == [8, 8, 4]
        staged = [r for r in PM.live_buffers(top=None) if r["tag"] == "staging" and r["dtype"] == "torch.float32"]
        assert sum(r["nbytes"] for r in staged) >= 40 * 4  # every slab's shards, beside the repacking
