"""The serving front door (``heat_tpu_torch.serving``: batcher, admission,
engine) against heat_tpu's on the CPU: the bucket ladder and the register
contract, the batcher's flush decisions and the admission decisions driven
alike through both packages' classes in one thread, the KMeans, KNN,
GaussianNB, Lasso and nn-Linear endpoints over ``MeshComm(4)`` against
heat_tpu's models over a 4-device mesh (labels exact; probabilities and
regression values to 1e-5 relative), the no-retrace law, deadline expiry,
``swap_weights``, ``close`` with and without drain, the quantized KNN
endpoint, the ``serving`` counter group of a deterministic single-threaded
drive equal to heat_tpu's, and a stall shed driven by events.  The mirror
is ``tests/test_serving.py``.

Every engine is closed in a ``finally``; a test waits only on futures and
``threading.Event``\\ s, with a timeout.
"""

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch import serving as TS
from heat_tpu_torch.core import telemetry as TT
from heat_tpu_torch.serving.batcher import Request as TRequest
from heat_tpu_torch.serving.engine import _pow2_buckets as t_ladder
from heat_tpu_torch.utils import fault as TF

RTOL = 1e-5
F = 8


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """A step builds its batch on the default device: the CPU here."""
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


@pytest.fixture(scope="module")
def meshes(ht):
    """Both packages' default mesh at 4 positions (a step builds its batch
    on the default mesh)."""
    jc, tc = ht.parallel.mesh.local_mesh(4), htt.MeshComm(4)
    prev = htt.get_device()
    htt.use_device("cpu")
    htt.use_comm(tc)
    ht.use_comm(jc)
    yield jc, tc
    ht.use_comm(None)
    htt.use_comm(None)
    htt.use_device(prev)


def _engine(**kw):
    TT.reset_group("serving")
    return TS.ServingEngine(**kw)


def _rows(seed, *sizes, f=F):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(r, f)).astype(np.float32) for r in sizes]


# ---------------------------------------------------------------- the ladder
def test_bucket_ladder_and_register_contract(ht):
    from heat_tpu.serving.engine import _pow2_buckets as j_ladder

    for lo, hi in ((8, 32), (3, 20), (16, 16), (1, 1), (5, 64)):
        assert t_ladder(lo, hi) == j_ladder(lo, hi)
    for bad in ((0, 8), (8, 0)):
        with pytest.raises(ValueError):
            t_ladder(*bad)
    eng = _engine()
    try:
        ep = eng.register("e", predict=lambda x: x, feature_dim=4, min_bucket=8, max_batch=32)
        assert [ep.bucket_for(r) for r in (1, 8, 9, 32)] == [8, 8, 16, 32] and ep.max_batch == 32
        with pytest.raises(ValueError):
            ep.bucket_for(33)
        with pytest.raises(ValueError, match="exactly one"):
            eng.register("x", feature_dim=4)
        with pytest.raises(ValueError, match="already registered"):
            eng.register("e", predict=lambda x: x, feature_dim=4)
        with pytest.raises(ValueError, match="feature_dim"):
            eng.register("z", predict=lambda x: x, feature_dim=0)
        with pytest.raises(ValueError, match="quantize_"):
            eng.register("q", predict=lambda x: x, feature_dim=4, quantize=True)
        with pytest.raises(KeyError):
            eng.submit("nope", np.zeros((1, 4), np.float32))
        with pytest.raises(ValueError, match=r"\(rows, 4\)"):
            eng.submit("e", np.zeros((2, 5), np.float32))
        with pytest.raises(ValueError, match="empty request"):
            eng.submit("e", np.zeros((0, 4), np.float32))
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit("e", np.zeros((1, 4), np.float32), deadline_s=0.0)
        with pytest.raises(TS.RequestRejected, match="too_large"):
            eng.submit("e", np.zeros((33, 4), np.float32))
        assert eng.stats()["shed"]["too_large"] == 1
        # a 1-D request is one row
        np.testing.assert_array_equal(np.ravel(eng.predict("e", np.arange(4, dtype=np.float32))), np.arange(4.0))
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.register("late", predict=lambda x: x, feature_dim=4)


# ------------------------------------------------- batcher and admission, alike
def _batcher_decisions(B, Req):
    """Flush decisions of ``_pick_locked`` on crafted queues (no worker)."""
    b = B(lambda *a: None)
    out = []

    def put(ep, rows, deadline, cap):
        b._caps[ep] = cap
        b._queues.setdefault(ep, deque()).append(Req(endpoint=ep, payload=None, rows=rows, t0=0.0, deadline=deadline))

    def pick(now):
        got, wait = b._pick_locked(now)
        out.append(None if got is None else (got[0], [r.rows for r in got[1]], got[2]))
        out.append(None if wait is None else round(wait, 6))

    put("a", 4, 10.0, 8)
    put("a", 4, 10.0, 8)
    pick(0.0)  # full bucket: max_batch at once
    put("a", 5, 1.0, 8)
    put("a", 2, 1.0, 8)
    pick(0.5)  # not due: the wait until the head's deadline
    pick(1.0)  # due: a partial batch on the timer
    put("a", 5, 2.0, 8)
    put("a", 4, 2.0, 8)
    pick(1.5)  # 9 rows fill the bucket: the 5, the 4 never split to fill it
    pick(1.5)
    pick(2.0)
    put("b", 1, 3.0, 8)
    put("c", 1, 2.0, 8)
    pick(5.0)  # two due queues: the earlier deadline first
    pick(5.0)
    put("d", 2, 60.0, 8)
    b._draining = True
    pick(0.0)  # drain flushes regardless of deadlines
    pick(0.0)
    return out


def _admission_decisions(A, Rejected, det):
    adm = A(max_queue_rows=8, retry_after_s=0.25)
    out = []

    def admit(rows, priority="normal", nbytes=0):
        try:
            adm.admit("e", rows, nbytes, priority=priority)
            out.append(("ok", adm.queued_rows))
        except Rejected as e:
            out.append((e.reason, e.retry_after_s, str(e)))
        except ValueError as e:
            out.append(("ValueError", str(e)))

    admit(3)
    admit(2, "low")  # low rides half the bound
    admit(2, "high")
    admit(4)  # 9 > 8
    admit(1, "platinum")
    adm.release(5)
    admit(4)
    adm.attach_stall_detector(det)
    det._notify("stall", quiet_s=1.0)
    admit(1)
    det._notify("recover")
    admit(1)
    adm.note_progress()
    out.append(adm.snapshot())
    adm.begin_drain()
    admit(1)
    adm.close()
    admit(1)
    det._notify("stall")
    out.append(adm.stalled)
    return out


def test_batcher_and_admission_decide_alike(ht):
    from heat_tpu.serving import AdmissionController, DynamicBatcher, RequestRejected
    from heat_tpu.serving.batcher import Request
    from heat_tpu.utils import fault as JF

    got = _batcher_decisions(TS.DynamicBatcher, TRequest)
    assert got == _batcher_decisions(DynamicBatcher, Request)
    assert got[:12] == [("a", [4, 4], "max_batch"), None, None, 0.5, ("a", [5, 2], "timer"), None,
                        ("a", [5], "max_batch"), None, None, 0.5, ("a", [4], "timer"), None]
    assert got[12:] == [("c", [1], "timer"), None, ("b", [1], "timer"), None, ("d", [2], "drain"), None, None, None]
    got = _admission_decisions(TS.AdmissionController, TS.RequestRejected, TF.StallDetector(timeout=60.0))
    assert got == _admission_decisions(AdmissionController, RequestRejected, JF.StallDetector(timeout=60.0))
    assert got[3][0] == "queue_full" and "retry after 0.25s" in got[3][2]


def test_admission_memory_gate():
    # no device reports: admit (never shed on made-up numbers); a starved
    # device (low_hbm) sheds hbm_pressure
    TS.AdmissionController(max_queue_rows=8).admit("e", 1, 1 << 40)
    with TF.injected(TF.FaultInjector().low_hbm(1024)):
        adm = TS.AdmissionController(max_queue_rows=8, memory_fraction=0.5)
        with pytest.raises(TS.RequestRejected, match="hbm_pressure"):
            adm.admit("e", 1, 10_000)
        adm.admit("e", 1, 256)


# ------------------------------------------------------------ the endpoints
@pytest.fixture(scope="module")
def fitted(ht, meshes):
    """Each endpoint's model in both packages: heat_tpu's fitted over its
    4-device mesh, the port's rebuilt from heat_tpu's state (KMeans, Lasso,
    GaussianNB) or fitted on the same data (KNN)."""
    jc, tc = meshes
    rng = np.random.default_rng(7)
    X = rng.normal(size=(64, F)).astype(np.float32)
    labels = (X[:, 0] > 0).astype(np.int32)
    y = (X @ rng.normal(size=(F, 1))).astype(np.float32)
    out = {}
    km = ht.cluster.KMeans(n_clusters=4, init="kmeans++", max_iter=5, random_state=0).fit(ht.array(X, split=0))
    out["kmeans"] = (km.predict, htt.cluster.kmeans_from_state(km.cluster_centers_.numpy(), km.n_iter_, km.inertia_,
                                                                device="cpu", comm=tc))
    las = ht.regression.Lasso(max_iter=10)
    las.fit(ht.array(X, split=0), ht.array(y, split=0))
    out["lasso"] = (las.predict, htt.regression.lasso_from_state(las.theta.numpy(), las.lam, las.n_iter, device="cpu",
                                                                  comm=tc))
    gnb = ht.naive_bayes.GaussianNB().fit(ht.array(X, split=0), ht.array(labels, split=0))
    out["gnb"] = (gnb.predict_proba, htt.naive_bayes.gaussiannb_from_state(
        gnb.classes_.numpy(), gnb.theta_.numpy(), gnb.var_.numpy(), gnb.class_prior_.numpy(),
        gnb.class_count_.numpy(), gnb.epsilon_, device="cpu", comm=tc))
    knns = []
    for pkg in (ht, htt):
        knns.append(pkg.classification.KNeighborsClassifier(n_neighbors=3).fit(
            pkg.array(X, split=0), pkg.array(labels, split=0)))
    out["knn"] = (knns[0].predict, knns[1])
    w, b = rng.normal(size=(4, F)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)
    jw, jb, tw, tb = ht.array(w), ht.array(b), htt.array(w), htt.array(b)
    out["linear"] = (lambda x: ht.nn.functional.linear(x, jw, jb), lambda x: htt.nn.functional.linear(x, tw, tb))
    return out


class _Proba:
    """GaussianNB served through its probabilities."""

    def __init__(self, model):
        self.model = model

    def predict(self, x):
        return self.model.predict_proba(x)


@pytest.mark.parametrize("name", ["kmeans", "lasso", "gnb", "knn", "linear"])
def test_endpoint_matches_heat_tpu(ht, fitted, name):
    j_predict, t_model = fitted[name]
    reqs = _rows(11, 3, 1, 5, 2)
    # one heat_tpu call over the stacked rows (each model is row-wise)
    stacked = j_predict(ht.array(np.concatenate(reqs), split=0)).numpy()
    want = np.split(stacked, np.cumsum([len(r) for r in reqs])[:-1])
    eng = _engine()
    try:
        kw = {"predict": t_model} if name == "linear" else {"model": _Proba(t_model) if name == "gnb" else t_model}
        eng.register(name, feature_dim=F, max_batch=16, **kw)
        direct = t_model if name == "linear" else (t_model.predict_proba if name == "gnb" else t_model.predict)
        with ThreadPoolExecutor(4) as pool:
            futs = list(pool.map(lambda r: eng.submit(name, r), reqs))
        got = [f.result(60) for f in futs]
    finally:
        eng.close()
    for r, g, w in zip(reqs, got, want):
        d = direct(htt.array(r, split=0)).numpy()
        assert g.shape == w.shape == d.shape
        # padding and coalescing are invisible: labels exact, values to the
        # rounding of another batch shape's product
        if name in ("kmeans", "knn"):
            np.testing.assert_array_equal(g, d)
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, d, rtol=RTOL, atol=1e-6)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)


def test_quantized_knn_endpoint_matches_heat_tpu(ht, meshes):
    rng = np.random.default_rng(21)
    corpus, labels = rng.normal(size=(64, 16)).astype(np.float32), rng.integers(0, 3, 64)
    reqs = [rng.normal(size=(m, 16)).astype(np.float32) for m in (5, 3)]
    j = ht.classification.KNeighborsClassifier(n_neighbors=3).fit(ht.array(corpus, split=0), ht.array(labels, split=0))
    j.quantize_("int8")
    stacked = j.predict(ht.array(np.concatenate(reqs), split=0)).numpy()
    want = np.split(stacked, np.cumsum([len(r) for r in reqs])[:-1])
    t = htt.classification.KNeighborsClassifier(n_neighbors=3).fit(htt.array(corpus, split=0),
                                                                     htt.array(labels, split=0))
    eng = _engine()
    try:
        eng.register("knn_q", t, feature_dim=16, max_batch=8, quantize=True)
        assert t.x is None and t._qx is not None
        got = [eng.predict("knn_q", r) for r in reqs]
    finally:
        eng.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- engine laws
def test_no_retrace_after_warmup_and_deadline_expiry(meshes, fitted):
    km = fitted["kmeans"][1]
    eng = _engine()
    try:
        ep = eng.register("km", km, feature_dim=F, min_bucket=8, max_batch=32, max_delay_s=0.002, warm=True)
        assert ep.buckets == (8, 16, 32) and eng.stats()["step_compiles"] == 3
        sizes = [1, 3, 8, 2, 16, 5, 7, 4, 1, 12, 32, 6] * 2
        payloads = _rows(3, *sizes)
        want = np.split(km.predict(htt.array(np.concatenate(payloads), split=0)).numpy(), np.cumsum(sizes)[:-1])
        fusion_before = TT.snapshot_group("fusion")["misses"]
        with ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(lambda p: eng.submit("km", p), payloads))
        for w, f in zip(want, futs):
            np.testing.assert_array_equal(f.result(60), w)
        st = eng.stats()
        assert TT.snapshot_group("fusion")["misses"] == fusion_before
        assert st["step_compiles"] == 3 and st["batched"] == st["accepted"] == len(sizes)
        assert st["padded_rows"] >= 1 and st["latency"]["km"]["count"] == len(sizes)
        # the client deadline (0.05 s) lapses before the flush timer
        # (0.25 s): the request resolves `expired` at flush, not computed
        eng.register("slow", km, feature_dim=F, max_batch=16, max_delay_s=0.25)
        doomed = eng.submit("slow", payloads[0], deadline_s=0.05, priority="low")
        with pytest.raises(TS.RequestRejected, match=r"serving request rejected \(expired\)"):
            doomed.result(10)
        st = eng.stats()
        assert st["shed"]["expired"] == 1 and st["shed_by_class"]["low"] == 1
        assert eng.admission.queued_rows == 0
    finally:
        eng.close()


class _Linear:
    def __init__(self, w):
        self.w = htt.array(w)

    def predict(self, x):
        return x @ self.w


def test_swap_weights_serves_new_operands_without_new_steps(meshes):
    rng = np.random.default_rng(5)
    w_old, w_new = rng.normal(size=(F, 4)).astype(np.float32), rng.normal(size=(F, 4)).astype(np.float32)
    model = _Linear(w_old)
    x = _rows(6, 2)[0]
    eng = _engine()
    try:
        eng.register("lin", model, feature_dim=F, max_batch=8, warm=True)
        eng.register("bare", predict=lambda v: v, feature_dim=F, max_batch=8)
        np.testing.assert_allclose(eng.predict("lin", x), x @ w_old, rtol=RTOL, atol=1e-6)
        compiles = eng.stats()["step_compiles"]
        old = eng.swap_weights("lin", {"w": htt.array(w_new)})
        np.testing.assert_allclose(eng.predict("lin", x), x @ w_new, rtol=RTOL, atol=1e-6)
        assert eng.stats()["step_compiles"] == compiles and eng.stats()["swaps"] == 1
        eng.swap_weights("lin", old)
        np.testing.assert_allclose(eng.predict("lin", x), x @ w_old, rtol=RTOL, atol=1e-6)
        with pytest.raises(ValueError, match="shape"):
            eng.swap_weights("lin", {"w": htt.array(np.zeros((F, 5), np.float32))})
        with pytest.raises(ValueError, match="dtype"):
            eng.swap_weights("lin", {"w": htt.array(np.zeros((F, 4), np.float64))})
        with pytest.raises(ValueError, match="split"):
            eng.swap_weights("lin", {"w": htt.array(w_new, split=0)})
        with pytest.raises(ValueError, match="no operand"):
            eng.swap_weights("lin", {"nope": w_new})
        with pytest.raises(ValueError, match="bare predict"):
            eng.swap_weights("bare", {"w": w_new})
    finally:
        eng.close()


@pytest.mark.parametrize("drain", [True, False])
def test_close_with_and_without_drain(meshes, drain):
    eng = _engine()
    eng.register("id", predict=lambda v: v * 2.0, feature_dim=4, max_batch=8, max_delay_s=60.0)
    reqs = _rows(8, 1, 2, 3, f=4)
    futs = [eng.submit("id", r) for r in reqs]
    eng.close(drain=drain)
    for r, f in zip(reqs, futs):
        if drain:
            np.testing.assert_array_equal(f.result(10), 2.0 * r)
        else:
            with pytest.raises(TS.RequestRejected, match="closed"):
                f.result(10)
    st = eng.stats()
    assert st["drains"] == 1 and st["flush_cause"]["drain"] == (1 if drain else 0)
    assert eng.admission.queued_rows == 0 and not eng._batcher._thread.is_alive()
    with pytest.raises(TS.RequestRejected, match="closed"):
        eng.submit("id", reqs[0])
    eng.close()  # idempotent


def test_failing_predict_resolves_futures_and_engine_serves_on(meshes):
    def boom(x):
        raise RuntimeError("model exploded")

    eng = _engine()
    try:
        eng.register("boom", predict=boom, feature_dim=4, max_batch=8)
        with pytest.raises(RuntimeError, match="model exploded"):
            eng.submit("boom", np.zeros((2, 4), np.float32)).result(10)
        assert eng.stats()["step_errors"] == 1 and eng.admission.queued_rows == 0
        eng.register("ok", predict=lambda v: v, feature_dim=4, max_batch=8)
        eng.predict("ok", np.zeros((1, 4), np.float32))
    finally:
        eng.close()


def _counter_drive(pkg, serving, telemetry):
    """A deterministic single-threaded drive; the serving group after it
    (latency aside)."""
    telemetry.reset_group("serving")
    eng = serving.ServingEngine()
    try:
        eng.register("id", predict=lambda v: v * 2.0, feature_dim=4, min_bucket=8, max_batch=16, max_delay_s=0.001,
                     warm=True)
        for rows in (1, 3, 9, 16, 8):
            eng.predict("id", np.ones((rows, 4), np.float32))
        eng.predict("id", np.ones((2, 4), np.float32), priority="high")
        for bad in ((17, "normal"), (1, "low")):
            try:
                if bad[1] == "low":
                    eng.admission.begin_drain()
                eng.submit("id", np.ones((bad[0], 4), np.float32), priority=bad[1])
            except serving.RequestRejected:
                pass
    finally:
        eng.close()
    snap = telemetry.serving_report()
    snap.pop("latency")
    return snap


def test_serving_counters_equal_heat_tpus(ht, meshes):
    from heat_tpu import serving as JS
    from heat_tpu.core import telemetry as JT

    got = _counter_drive(htt, TS, TT)
    assert got == _counter_drive(ht, JS, JT)
    assert got["step_compiles"] == 2 and got["flush_cause"]["max_batch"] == 1 and got["shed"]["draining"] == 1


def test_injected_stall_sheds_then_recovers(meshes):
    """A stall at ``fusion.exec`` inside a batch latches admission through
    the detector's subscription; new work sheds ``stalled``; the stalled
    batch still lands, and its beat clears the latch."""
    det = TF.StallDetector(timeout=0.2)
    eng = _engine(admission=TS.AdmissionController(retry_after_s=0.05))
    eng.attach_stall_detector(det)
    stalled, recovered = threading.Event(), threading.Event()
    det.subscribe(lambda kind, info: (stalled if kind == "stall" else recovered if kind == "recover" else
                                      threading.Event()).set())
    det.start()
    try:
        eng.register("exp", predict=lambda v: htt.exp(v), feature_dim=F, min_bucket=8, max_batch=8, warm=True)
        # the warm-up was quiet work on this thread: re-arm the clock and
        # forget what the detector said meanwhile
        det.beat()
        stalled.clear()
        recovered.clear()
        x = _rows(9, 2)[0]
        with TF.injected(TF.FaultInjector().stall_in("fusion.exec", 0.8)) as inj:
            wedged = eng.submit("exp", x)
            assert stalled.wait(10), "the detector never saw the stall"
            with pytest.raises(TS.RequestRejected, match="stalled") as e:
                eng.submit("exp", x)
            assert e.value.reason == "stalled" and e.value.retry_after_s == 0.05
            np.testing.assert_allclose(wedged.result(30), np.exp(x), rtol=RTOL)
        assert recovered.wait(10)
        # an idle engine beats no one: the watchdog's part is done
        det.pause()
        assert inj.fired == [("stall", "fusion.exec")] and not eng.admission.stalled
        np.testing.assert_allclose(eng.predict("exp", x), np.exp(x), rtol=RTOL)
        assert eng.stats()["shed"]["stalled"] == 1
    finally:
        eng.close()
        det.stop()
    assert not det._thread.is_alive()


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_kmeans_endpoint_on_card_through_k1(cuda):
    from heat_tpu_torch.ops import cdist as k1

    prev_comm = htt.get_comm()
    htt.use_comm(htt.MeshComm(4))
    htt.use_device("gpu")
    g = torch.Generator(device=cuda).manual_seed(0)
    centres = torch.randn(8, 64, generator=g, device=cuda)
    km = htt.cluster.kmeans_from_state(centres.cpu().numpy(), 1, 0.0, comm=htt.MeshComm(4))
    eng = _engine()
    try:
        eng.register("km", km, feature_dim=64, min_bucket=8, max_batch=32, max_delay_s=0.002, warm=True)
        reqs = [torch.randn(r, 64, generator=g, device=cuda).cpu().numpy() for r in (1, 4, 3, 2) * 4]
        k1.launches = 0
        futs = [eng.submit("km", r) for r in reqs]
        got = [f.result(60) for f in futs]
        batches = eng.stats()["batches"]
        assert k1.launches == 4 * batches
        for r, lab in zip(reqs, got):
            d = torch.cdist(torch.from_numpy(r).double(), centres.double().cpu())
            np.testing.assert_array_equal(lab.ravel(), d.argmin(1).numpy())
    finally:
        eng.close()
        htt.use_comm(None if prev_comm is htt.parallel.mesh.world() else prev_comm)
