"""``heat_tpu_torch.core.stream`` and the three ``fit_stream``\\ s against
heat_tpu's on the CPU: the pass plan and the budget's resolution chain, the
slabs of a pass (fixed rows, the tail zero-padded), a reader's error handed
to the consumer, the measured report, an out-of-memory error injected
mid-pass (the port through ``guard.fire("stream.slab")``, heat_tpu through
its ``FaultInjector``), and ``KMeans``/``GaussianNB``/KNN ``fit_stream``
on the same ``.npy`` and HDF5 files.  The mirror is ``tests/test_stream.py``.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import guard as PG
from heat_tpu_torch.core import stream as PS

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The fits stream to the default device, as heat_tpu's do: the CPU here."""
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _data(n=2000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[: n // 3] += 4.0
    x[n // 3 : 2 * n // 3] -= 4.0
    return x


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    d = tmp_path_factory.mktemp("stream")
    x = _data()
    npy = str(d / "x.npy")
    np.save(npy, x)
    h5 = str(d / "x.h5")
    with h5py.File(h5, "w") as fh:
        fh["x"] = x
    return {"npy": (npy, None), "h5": (h5, "x"), "x": x}


def _mesh(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("budget", [None, 3 * 1000, 40_000, 10**9])
def test_plan_matches(ht, n, budget):
    from heat_tpu.core import stream as JS

    x = _data(1000, 5)
    jc, tc = _mesh(ht, n)
    want = JS.plan_pass(JS.open_source(x), comm=jc, site="t", budget=budget)
    got = PS.plan_pass(PS.open_source(x), comm=tc, site="t", budget=budget)
    assert tuple(got) == tuple(want)
    assert got.slab_rows % n == 0 and got.slab_rows * got.row_bytes <= max(got.budget // 3, n * got.row_bytes)


def test_budget_chain_matches(ht, monkeypatch):
    from heat_tpu.core import stream as JS

    assert PS.DEFAULT_BUDGET == JS.DEFAULT_BUDGET
    for S in (PS, JS):
        assert S.residency_budget(12345) == 12345
    monkeypatch.setenv("HEAT_TPU_STREAM_BUDGET", str(3 << 20))
    assert PS.residency_budget() == JS.residency_budget() == 3 << 20
    monkeypatch.delenv("HEAT_TPU_STREAM_BUDGET")
    # no device reports free memory on the CPU: the static default
    assert PS.residency_budget() == JS.residency_budget() == PS.DEFAULT_BUDGET


def _slabs(S, src, comm, budget, **dev):
    sp = S.StreamPass(S.open_source(src), comm=comm, budget=budget, **dev)
    rows = [(s.index, s.valid, s.base, tuple(s.x.shape), s.x.split, np.asarray(s.x.numpy())) for s in sp]
    return rows, S.finish_pass(sp)


@pytest.mark.parametrize("n", MESHES)
def test_slabs_pad_the_tail_as_heat_tpu_does(ht, n):
    from heat_tpu.core import stream as JS

    x = _data(1001, 3)
    jc, tc = _mesh(ht, n)
    want, jrep = _slabs(JS, x, jc, 3 * 128 * 12)
    got, trep = _slabs(PS, x, tc, 3 * 128 * 12)
    assert [r[:5] for r in got] == [r[:5] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[5], w[5])
        assert not g[5][g[1]:].any()
    assert sorted(trep) == sorted(jrep) and 0.0 <= trep["overlap_frac"] <= 1.0
    assert trep["slabs"] == jrep["slabs"] == len(got) and trep["bytes_read"] == x.nbytes
    assert PS.stats().keys() == JS.stats().keys()


class _BrokenSource(PS.ChunkSource):
    shape = (100, 2)
    np_dtype = np.dtype(np.float32)

    def read(self, lo, hi):
        if lo >= 40:
            raise OSError("disk gone")
        return np.ones((hi - lo, 2), np.float32)


def test_reader_error_reaches_the_consumer():
    sp = PS.StreamPass(_BrokenSource(), comm=htt.MeshComm(2), budget=3 * 20 * 8)
    seen = []
    with pytest.raises(RuntimeError, match="stream reader failed") as ctx:
        for s in sp:
            seen.append(s.valid)
    assert isinstance(ctx.value.__cause__, OSError)
    assert seen and sum(seen) <= 40
    assert not sp._reader.is_alive()


class _OOMOnce:
    def __init__(self):
        self.fired = []

    def fire_site(self, site):
        if site == "stream.slab" and len(self.fired) == 0 and self.armed:
            self.fired.append(site)
            raise torch.OutOfMemoryError("injected out of memory")

    def corrupt_site(self, site, value):
        return value


@pytest.mark.parametrize("n", (1, 4))
def test_injected_oom_mid_pass_gives_heat_tpus_result(ht, files, n):
    from heat_tpu.utils import fault

    path, _ = files["npy"]
    x = files["x"]
    jc, tc = _mesh(ht, n)
    budget = x.nbytes // 4
    kw = dict(n_clusters=3, init="random", max_iter=3, tol=-1.0, random_state=4)
    inj = fault.FaultInjector(seed=0).oom_in("stream.slab", times=1)
    with fault.injected(inj):
        j = ht.cluster.KMeans(**kw).fit_stream(path, comm=jc, budget=budget)
    rec = _OOMOnce()
    rec.armed = True
    PG._INJECTOR = rec
    try:
        t = htt.cluster.KMeans(**kw).fit_stream(path, comm=tc, budget=budget)
    finally:
        PG._INJECTOR = None
    clean = htt.cluster.KMeans(**kw).fit_stream(path, comm=tc, budget=budget)
    assert rec.fired == ["stream.slab"]
    assert inj.fired[0][1] == "stream.slab"
    np.testing.assert_array_equal(t.cluster_centers_.numpy(), clean.cluster_centers_.numpy())
    np.testing.assert_allclose(t.cluster_centers_.numpy(), np.asarray(j.cluster_centers_.larray), rtol=1e-4,
                               atol=1e-4)
    assert t.n_iter_ == j.n_iter_ == 3


def test_oom_retry_counted_and_slab_halved():
    x = _data(400, 2)
    rec = _OOMOnce()
    rec.armed = True
    before = PS.stats()["oom_retries"]
    sp = PS.StreamPass(PS.open_source(x), comm=htt.MeshComm(4), budget=3 * 100 * 8)
    PG._INJECTOR = rec
    try:
        got = [(s.valid, s.base) for s in sp]
    finally:
        PG._INJECTOR = None
    rep = PS.finish_pass(sp)
    assert rep["oom_retries"] == 1 and PS.stats()["oom_retries"] == before + 1
    assert rep["slab_rows"] == 48 and sum(v for v, _ in got) == 400
    assert [b for _, b in got][:3] == [0, 48, 96]


@pytest.mark.parametrize("fmt", ["npy", "h5"])
@pytest.mark.parametrize("n", MESHES)
def test_kmeans_fit_stream_matches(ht, files, fmt, n):
    path, dset = files[fmt]
    x = files["x"]
    jc, tc = _mesh(ht, n)
    kw = dict(n_clusters=3, init="random", max_iter=6, random_state=1)
    j = ht.cluster.KMeans(**kw).fit_stream(path, dset, comm=jc, budget=x.nbytes // 4)
    t = htt.cluster.KMeans(**kw).fit_stream(path, dset, comm=tc, budget=x.nbytes // 4)
    assert t.n_iter_ == j.n_iter_ and t.labels_ is None and j.labels_ is None
    np.testing.assert_allclose(t.cluster_centers_.numpy(), np.asarray(j.cluster_centers_.larray), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=1e-4)
    m = htt.cluster.KMeans(**kw).fit(htt.array(x, split=0, comm=tc))
    np.testing.assert_allclose(t.cluster_centers_.numpy(), m.cluster_centers_.numpy(), rtol=1e-4, atol=1e-4)
    assert t.last_stream_report["slabs"] >= 4


@pytest.mark.parametrize("fmt", ["npy", "h5"])
@pytest.mark.parametrize("n", (1, 4))
def test_gaussiannb_fit_stream_matches(ht, files, fmt, n):
    path, dset = files[fmt]
    x = files["x"]
    y = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 1).astype(np.int64)
    jc, tc = _mesh(ht, n)
    j = ht.naive_bayes.GaussianNB().fit_stream(path, y, dset, comm=jc, budget=x.nbytes // 4)
    t = htt.naive_bayes.GaussianNB().fit_stream(path, y, dset, comm=tc, budget=x.nbytes // 4)
    for attr in ("theta_", "var_", "class_prior_", "class_count_"):
        np.testing.assert_allclose(getattr(t, attr).numpy(), np.asarray(getattr(j, attr).larray), rtol=1e-4,
                                   atol=1e-5, err_msg=attr)
    np.testing.assert_allclose(t.epsilon_, j.epsilon_, rtol=1e-5)
    q = htt.array(x[:50], comm=tc)
    np.testing.assert_array_equal(t.predict(q).numpy(), np.asarray(j.predict(ht.array(x[:50], comm=jc)).larray))


@pytest.mark.parametrize("fmt", ["npy", "h5"])
@pytest.mark.parametrize("n", (1, 4))
def test_knn_fit_stream_matches(ht, files, fmt, n):
    path, dset = files[fmt]
    x = files["x"]
    y = (x[:, 2] > 0).astype(np.int64)
    jc, tc = _mesh(ht, n)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((17, x.shape[1])).astype(np.float32) * 3.0
    j = ht.classification.KNeighborsClassifier(n_neighbors=5).fit_stream(path, y, dset, comm=jc,
                                                                        budget=x.nbytes // 4)
    t = htt.classification.KNeighborsClassifier(n_neighbors=5).fit_stream(path, y, dset, comm=tc,
                                                                         budget=x.nbytes // 4)
    got = t.predict(htt.array(q, comm=tc)).numpy()
    want = np.asarray(j.predict(ht.array(q, comm=jc)).larray)
    mem = htt.classification.KNeighborsClassifier(n_neighbors=5).fit(
        htt.array(x, split=0, comm=tc), htt.array(y, split=0, comm=tc))
    d = ((q[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    srt = np.sort(d, axis=1)
    clear = (srt[:, 5] - srt[:, 4]) > 1e-4 * srt[:, 5]
    assert clear.sum() >= 12
    np.testing.assert_array_equal(got[clear], want[clear])
    np.testing.assert_array_equal(got[clear], mem.predict(htt.array(q, comm=tc)).numpy()[clear])
    t.close_stream()
    j.close_stream()
    assert t._stream_src is None


def test_knn_equal_through_mid_stream_oom(ht, files):
    """heat_tpu's ``test_knn_equal_through_mid_stream_oom``: one injected
    out-of-memory error mid-pass halves the slab, and the labels do not
    change (the merge holds no sums)."""
    from heat_tpu.utils import fault

    path, _ = files["npy"]
    x = files["x"]
    y = (x[:, 3] > 0).astype(np.int64)
    q = np.random.default_rng(12).normal(size=(32, x.shape[1])).astype(np.float32) + 2.0
    budget = x.nbytes // 4
    j = ht.classification.KNeighborsClassifier(n_neighbors=5).fit_stream(path, y, budget=budget)
    inj = fault.FaultInjector(seed=0).oom_in("stream.slab", times=1)
    with fault.injected(inj):
        want = np.asarray(j.predict(ht.array(q, split=0)).larray)
    j.close_stream()
    t = htt.classification.KNeighborsClassifier(n_neighbors=5).fit_stream(path, y, budget=budget)
    clean = t.predict(htt.array(q, split=0)).numpy()
    rec = _OOMOnce()
    rec.armed = True
    PG._INJECTOR = rec
    try:
        got = t.predict(htt.array(q, split=0)).numpy()
    finally:
        PG._INJECTOR = None
    t.close_stream()
    assert t.last_stream_report["oom_retries"] == j.last_stream_report["oom_retries"] == 1
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_array_equal(got, want)
