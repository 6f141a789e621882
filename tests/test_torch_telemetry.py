"""``heat_tpu_torch.core.telemetry`` (``ht.telemetry``) against heat_tpu's
on the CPU: each scenario runs on both modules and their observable
results are compared: the level gates, the counter registry (group names,
snapshot keys, in-place resets), the Prometheus text, the flight
recorder's events (kinds, order, cursor, envelope, evictions), span
nesting, the program ledger and its sampling gate, the dump document and
the Chrome-trace rendering.  Call sites of the port (spans, ledger entries
and events of the estimators, the sparse layer and the transport engine)
are held against heat_tpu's where it has the same site.  The mirrors are
``tests/test_telemetry.py`` and ``tests/test_roofline.py``.

Every scenario restores the level, the capacity and the sampling period
it changed, and unregisters the groups it registered.
"""

import io
import json
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import telemetry as PT


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JT(ht):
    from heat_tpu.core import telemetry

    return telemetry


@contextmanager
def level(T, name):
    prev = T.set_level(name)
    T.clear_events()
    T.reset_programs()
    try:
        yield
    finally:
        T.set_level(prev)
        T.clear_events()
        T.reset_programs()


@pytest.mark.parametrize("raw", ["off", "0", "none", "counters", "", "on", "events", "trace", "TRACE ", "junk"])
def test_env_levels_parse_alike(JT, monkeypatch, raw):
    monkeypatch.setenv("HEAT_TPU_TELEMETRY", raw)
    assert PT._env_level() == JT._env_level()


def test_default_level_and_set_level(JT):
    assert PT.level() == "counters"
    for T in (PT, JT):
        prev = T.set_level("events")
        assert T.events_enabled() and T.ledger_enabled() and not T.trace_enabled()
        assert T.set_level(3) == "events" and T.level() == "trace"
        T.set_level(prev)
        with pytest.raises(ValueError):
            T.set_level("loud")
        with T.telemetry_level("off"):
            assert not T.ledger_enabled()
        assert T.level() == prev


def test_snapshot_group_names_and_keys_match(JT):
    for name in ("telemetry", "memtrack", "transport", "stream"):
        assert sorted(PT.snapshot_group(name)) == sorted(JT.snapshot_group(name)), name
    assert PT.snapshot()["telemetry"]["level"] == "counters"


def test_registry_resets_in_place(JT):
    defaults = {"hits": 0, "by_kind": {"a": 0}, "last": None}
    snaps = []
    for T in (PT, JT):
        live = T.register_group("probe_registry", defaults, extra=lambda: {"size": 7})
        try:
            alias = live["by_kind"]
            assert T.register_group("probe_registry", {"other": 1}) is live  # idempotent
            live["hits"] += 3
            alias["a"] += 1
            alias["b"] = 2
            live["new"] = 1
            before = T.snapshot_group("probe_registry")
            T.reset_group("probe_registry")
            assert live["by_kind"] is alias  # nested dicts keep their identity
            snaps.append((before, T.snapshot_group("probe_registry"), sorted(T.snapshot())[:0]))
        finally:
            T._GROUPS.pop("probe_registry", None)
    assert snaps[0] == snaps[1]
    assert snaps[0][1] == {"hits": 0, "by_kind": {"a": 0}, "last": None, "size": 7}


def test_prometheus_text_matches(JT):
    group = {"hit rate%": 3, "nested": {"a": 1.5, "b": None, "c": True, "d": "text"}}
    texts = []
    for T in (PT, JT):
        T.register_group("weird.group", group)
        try:
            lines = []
            T._prom_lines("heat_tpu_weird_group", T.snapshot_group("weird.group"), lines, src="weird.group")
            texts.append("\n".join(lines))
            full = T.export_prometheus()
        finally:
            T._GROUPS.pop("weird.group", None)
        assert full.endswith("\n")
        assert ("# HELP heat_tpu_weird_group_hit_rate_ heat_tpu telemetry gauge weird.group.hit rate%\n"
                "# TYPE heat_tpu_weird_group_hit_rate_ gauge\nheat_tpu_weird_group_hit_rate_ 3") in full
    assert texts[0] == texts[1]
    # the port's whole exposition is well formed: every sample typed,
    # documented and numeric
    helped, typed = set(), set()
    for ln in filter(None, PT.export_prometheus().splitlines()):
        if ln.startswith("# HELP "):
            helped.add(ln.split(" ")[2])
        elif ln.startswith("# TYPE "):
            typed.add(ln.split(" ")[2])
        else:
            metric, value = ln.rsplit(" ", 1)
            family = metric.split("{", 1)[0]
            assert family in typed and family in helped
            float(value)
    for expected in ("heat_tpu_transport_oom_retries", "heat_tpu_telemetry_events", "heat_tpu_stream_sources",
                     "heat_tpu_memtrack_registered", "heat_tpu_mem_live_bytes"):
        assert expected in typed


def _recorder_scenario(T):
    out = {}
    prev_cap = T.set_capacity(8)
    try:
        with level(T, "events"):
            seqs = [T.record_event("probe", i=i) for i in range(20)]
            got = T.events("probe")
            out["ring"] = [e["i"] for e in got]
            out["ordered"] = [e["seq"] for e in got] == sorted(e["seq"] for e in got)
            out["since"] = [e["i"] for e in T.events(since=seqs[16])]
            out["dropped"] = T.snapshot()["telemetry"]["events_dropped"]
            T.record_event("other", tid="shadow", kind="k", seq=1, ts=2, span=3, value=4)
            e = T.events("other")[-1]
            out["rekeyed"] = sorted(k for k in e if k.startswith("x_")), e["value"], e["tid"] == threading.get_ident()
            T.clear_events()
            out["cleared"] = T.events()
    finally:
        T.set_capacity(prev_cap)
    return out


def test_flight_recorder_matches(JT):
    got, want = _recorder_scenario(PT), _recorder_scenario(JT)
    assert got == want
    assert got["ring"] == list(range(12, 20)) and got["dropped"] == 12


def _span_scenario(T):
    with level(T, "events"):
        @T.span("outer.fn", kind="deco")
        def fn():
            """doc"""
            with T.span("inner", tile=4):
                T.record_event("inside")
                cur = T.current_span()
                opened = [s["name"] for s in T.open_spans()]
            return cur, opened

        cur, opened = fn()
        with pytest.raises(KeyError):
            with T.span("failing"):
                raise KeyError("x")
        evs = T.events()
        ids = {e["id"]: e["name"] for e in evs if e["kind"] == "span_begin"}
        rows = []
        for e in evs:
            row = [e["kind"], e.get("name"), ids.get(e["span"]), ids.get(e.get("parent"))]
            row += [e.get(k) for k in ("kind_", "tile", "status", "error")]
            rows.append(row)
        return (rows, cur["name"], ids.get(cur["parent"]), opened, fn.__doc__, fn.__name__, T.current_span(),
                T.open_spans())


def test_spans_nest_alike(JT):
    got, want = _span_scenario(PT), _span_scenario(JT)
    assert got == want
    assert got[0][0][:2] == ["span_begin", "outer.fn"] and got[0][2] == ["inside", None, "inner", None] + [None] * 4


def test_level_gates_match(JT):
    for T in (PT, JT):
        with level(T, "off"):
            assert T.record_event("probe") is None
            with T.span("dead"):
                assert T.current_span() is None
            T.ensure_program("fp0", kind="x")
            T.record_timing("fp0", 1.0)
            assert T.events() == [] and T.programs() == []
            assert not any(T.timing_active() for _ in range(40))
        with level(T, "counters"):
            T.ensure_program("fp1", kind="x", flops=2.0, hbm_bytes=8.0)
            T.ensure_program("fp1", kind="x")
            T.program_hit("fp1")
            T.annotate_program("fp1", note=1)
            T.annotate_program("unseen", note=1)
            assert T.events() == []
            (entry,) = T.programs()
            assert (entry["compiles"], entry["hits"], entry["note"]) == (1, 2, 1)
        with level(T, "events"):
            assert all(T.timing_active() for _ in range(5))


def test_sampling_gate_matches(JT):
    seqs = []
    for T in (PT, JT):
        prev = T.set_sample_every(3)
        try:
            with level(T, "counters"):
                seqs.append(sum(T.timing_active() for _ in range(30)))
        finally:
            T.set_sample_every(prev)
    assert seqs == [10, 10]


def test_ledger_timings_and_views_match(JT):
    views = []
    for T in (PT, JT):
        with level(T, "events"):
            T.record_program("fpA", kind="kernel_probe", flops=10.0, hbm_bytes=20.0, dtype="float32")
            for d in (0.3, 0.1, 0.2):
                T.record_timing("fpA", d)
            T.record_peak("fpA", 512, "ledger")
            T.record_peak("fpA", 256, "device")
            T.record_program("fpA", kind="kernel_probe", flops=10.0, hbm_bytes=20.0, dtype="float32")
            (e,) = T.programs()
            views.append({k: e[k] for k in ("calls", "total_s", "min_s", "p50_s", "peak_bytes", "mem_source",
                                              "compiles", "hits", "flops", "hbm_bytes")})
            out = T.timed_call("fpB", lambda a, b: a + b, 1, 2)
            assert out == 3 and [p for p in T.programs() if p["fingerprint"] == "fpB"] == []  # unledgered
            T.record_program("fpB")  # its earlier timing shows once it is ledgered
            T.timed_call("fpB", lambda: None)
            assert [p["calls"] for p in T.programs() if p["fingerprint"] == "fpB"] == [2]
    assert views[0] == views[1]
    # a non-kernel site leaves the work fields None in the port
    with level(PT, "counters"):
        PT.record_program("fpC", kind="program")
        assert PT.programs()[0]["flops"] is None and PT.programs()[0]["hbm_bytes"] is None


def test_dump_and_trace_export_match(JT, tmp_path):
    docs, traces = [], []
    for T in (PT, JT):
        with level(T, "events"):
            with T.span("a", tile=1):
                T.record_event("probe", i=1)
                with T.span("b"):
                    pass
            open_span = T.span("left-open").__enter__()
            buf = io.StringIO()
            T.dump(buf)
            doc = json.loads(buf.getvalue())
            docs.append((sorted(doc), doc["telemetry_level"], [e["kind"] for e in doc["events"]],
                         [s["name"] for s in doc["open_spans"]], sorted(doc["buffers"])))
            trace = T.export_trace()
            traces.append([(e["ph"], e["name"], e.get("args", {}).get("status")) for e in trace])
            T.export_trace(str(tmp_path / f"{T.__name__}.json"))
            assert json.load(open(tmp_path / f"{T.__name__}.json"))
            open_span.__exit__(None, None, None)
    assert docs[0] == docs[1] and traces[0] == traces[1]


def test_postmortem_writes_the_dump(JT, monkeypatch, tmp_path):
    for T, name in ((PT, "port"), (JT, "jax")):
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("HEAT_TPU_TELEMETRY_DUMP", str(path))
        with level(T, "events"):
            T.postmortem("probe_reason", detail=1)
            T.postmortem("probe_reason", detail=2)
            assert [e["detail"] for e in T.events("postmortem")] == [1, 2]
        assert path.exists() and (tmp_path / f"{name}.json.2").exists()
        assert (tmp_path / f"{name}.json.trace.json").exists()


def test_trace_level_spans_reach_the_torch_profiler():
    with level(PT, "trace"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with PT.span("probe.traced"):
                torch.ones(4).sum()
    assert "probe.traced" in {e.key for e in prof.key_averages()}


def test_unported_reports_name_item_13(ht):
    """Item 13's serving and router reports, ported: once the front door is
    imported, each is its counter group, with heat_tpu's keys."""
    import heat_tpu.serving  # noqa: F401 — registers heat_tpu's groups
    import heat_tpu_torch.serving  # noqa: F401 — registers the port's
    from heat_tpu.core import telemetry as JT

    for name in ("serving", "router"):
        got, want = getattr(PT, f"{name}_report")(), getattr(JT, f"{name}_report")()
        assert got == PT.snapshot_group(name) and set(got) == set(want)
    # the tuning plane is ported: its report is autotune.report()'s
    rep = PT.autotune_report()
    assert set(rep) == {"device_kind", "enabled", "generation", "stats", "rows"}
    assert rep["rows"] == htt.autotune.report()["rows"]


# ------------------------------------------------------------ call sites
def test_estimator_spans_and_kernel_ledger_entries():
    rng = np.random.default_rng(0)
    comm = htt.MeshComm(4)
    x = htt.array(rng.standard_normal((64, 5)).astype(np.float32), split=0, comm=comm, device="cpu")
    y = htt.array(rng.standard_normal((64, 1)).astype(np.float32), split=0, comm=comm, device="cpu")
    with level(PT, "events"):
        htt.cluster.KMeans(n_clusters=3, max_iter=4, tol=-1.0, random_state=0).fit(x)
        htt.regression.Lasso(lam=0.01, max_iter=3).fit(x, y)
        htt.linalg.qr(htt.array(rng.standard_normal((64, 5)).astype(np.float32), split=None, comm=comm, device="cpu"))
        labels = htt.array((np.arange(64) % 2).astype(np.int64), split=0, comm=comm, device="cpu")
        htt.naive_bayes.GaussianNB().fit(x, labels).predict(x)
        htt.classification.KNeighborsClassifier(n_neighbors=3).fit(x, labels).predict(x)
        begun = [e["name"] for e in PT.events("span_begin")]
        programs = PT.programs()
        progs = {p["kind"]: p for p in programs}
    for name in ("kmeans.fit", "lasso.fit", "gaussiannb.fit", "gaussiannb.predict", "knn.predict"):
        assert name in begun, name
    # K1's entries: the Lloyd step (every step timed at events) and KNN's distances
    cdist = sorted((p["flops"], p.get("calls")) for p in programs if p["kind"] == "kernel_cdist")
    assert cdist == [(2.0 * 64 * 3 * 5, 4), (2.0 * 64 * 64 * 5, 1)]
    assert progs["kernel_lasso_sweep"]["flops"] == 4.0 * 64 * 6 and progs["kernel_lasso_sweep"]["calls"] == 3
    assert progs["kernel_qr_panel"]["flops"] == 64 * 5 * 6
    assert progs["gaussiannb_fit"]["flops"] is None


def test_sparse_events_match_heat_tpu(ht, JT):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    fields = []
    for T, pkg, kw in ((PT, htt, {"device": "cpu"}), (JT, ht, {})):
        with level(T, "events"):
            g = pkg.sparse.knn_graph(pkg.array(x, split=0, **kw), 4)
            pkg.sparse.todense(g)
            ev = T.events("knn_graph")[-1]
            de = T.events("sparse_densify")[-1]
            fields.append(({k: ev[k] for k in ("n", "k", "nnz", "density", "weights", "symmetrize")},
                           tuple(de["shape"]), de["nnz"], de["split"]))
    assert fields[0] == fields[1]


def test_transport_spans_and_programs():
    comm = htt.MeshComm(4)
    x = htt.array(np.arange(60, dtype=np.float32).reshape(12, 5), split=0, comm=comm, device="cpu")
    with level(PT, "events"):
        x.resplit_(1)
        htt.reshape(htt.array(np.arange(60, dtype=np.float32), split=0, comm=comm, device="cpu"), (3, 4, 5),
                    new_split=1)
        htt.array(np.arange(60, dtype=np.float32).reshape(12, 5), split=0, comm=comm, device="cpu")[np.array([3, 0, 11])]
        names = [e["name"] for e in PT.events("span_begin")]
        kinds = {p["kind"]: p for p in PT.programs()}
    assert "transport.resplit" in names and "transport.reshape" in names and "transport.take" in names
    assert kinds["kernel_repack"]["hbm_bytes"] == 2 * 60 * 4 and kinds["transport_resplit"]["flops"] is None
    time.sleep(0)  # the recorder holds no thread


def test_card_timings_wait_only_for_a_report(monkeypatch):
    # on the card a sampled call records two CUDA events and leaves them
    # pending; nothing on the path waits for them (an unfinished sample past
    # the bound is dropped), and programs() folds them in
    waits = []

    class Event:
        done = False

        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.t = time.perf_counter()

        def query(self):
            return Event.done

        def synchronize(self):
            waits.append(1)

        def elapsed_time(self, end):
            return 2.0  # ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(PT, "_PENDING_MAX", 3)
    with level(PT, "events"):
        PT.record_program("fpE", kind="kernel_probe")
        seen = []
        for _ in range(5):
            assert PT.timed_call("fpE", lambda: 7, device=torch.device("cuda"), observer=seen.append) == 7
        assert waits == [] and len(PT._PENDING) == 3  # the two oldest unfinished samples were dropped
        Event.done = True
        PT.timed_call("fpE", lambda: 7, device="cuda", observer=seen.append)
        assert len(PT._PENDING) == 0 and seen == [0.002] * 4 and waits == []  # finished ones fold in, unwaited
        PT.timed_call("fpE", lambda: 7, device="cuda")
        (e,) = PT.programs()  # the report waits for what is pending
        assert e["calls"] == 5 and e["min_s"] == 0.002 and waits == [1]
