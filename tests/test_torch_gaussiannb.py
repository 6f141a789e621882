"""GaussianNB: heat_tpu_torch against heat_tpu on the CPU at meshes 1, 4
and 8, against the reference Heat's iris probabilities, and on the card
against the CPU.

``heat_tpu/datasets/iris_y_pred_proba.csv`` is the reference Heat's
``predict_proba`` of a GaussianNB fitted on ``iris_X_train.csv`` /
``iris_y_train.csv`` and applied to ``iris_X_test.csv``: an oracle
independent of both packages, met to 1e-12 in float64 (read as data files,
not through the JAX package).  Moments are sums in other orders than XLA's:
float32 parity is to 1e-5 relative (theta, var, log-probabilities), float64
to 1e-12; labels are equal.
"""

import os

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.naive_bayes import gaussianNB as gnb_mod

IRIS = os.path.join(os.path.dirname(__file__), os.pardir, "heat_tpu", "datasets")


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


MESHES = (1, 4, 8)
F32 = dict(rtol=1e-5, atol=1e-5)


def _iris():
    load = lambda name: np.loadtxt(os.path.join(IRIS, name), delimiter=";")  # noqa: E731
    return (load("iris_X_train.csv"), load("iris_y_train.csv").astype(np.int64), load("iris_X_test.csv"),
            load("iris_y_pred_proba.csv"))


def _blobs(seed=0, n=61, f=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n).astype(np.int32)
    centres = np.array([[0, 0, 0, 0], [4, 1, -2, 3], [-3, 5, 1, 1]], np.float64)[:, :f] + 10.0
    x = (centres[y] + rng.normal(size=(n, f)) * np.array([1.0, 0.5, 2.0, 1.5])[:f]).astype(dtype)
    return x, y


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


@pytest.mark.parametrize("n", MESHES)
def test_iris_oracle(n):
    x, y, xt, proba = _iris()
    tc = htt.MeshComm(n)
    for split in (None, 0):
        m = htt.naive_bayes.GaussianNB().fit(htt.array(x, split=split, comm=tc, device="cpu"),
                                             htt.array(y, split=split, comm=tc, device="cpu"))
        got = m.predict_proba(htt.array(xt, split=split, comm=tc, device="cpu"))
        assert got.split == split and got.dtype is htt.float64
        np.testing.assert_allclose(got.numpy(), proba, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(m.predict(htt.array(xt, split=split, comm=tc, device="cpu")).numpy(),
                                      np.argmax(proba, axis=1))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (None, 0))
def test_fit_predict_against_jax(ht, n, split):
    x, y = _blobs()
    jc, tc = _pair(ht, n)
    jm = ht.naive_bayes.GaussianNB().fit(ht.array(x, split=split, comm=jc), ht.array(y, split=split, comm=jc))
    tm = htt.naive_bayes.GaussianNB().fit(htt.array(x, split=split, comm=tc, device="cpu"),
                                          htt.array(y, split=split, comm=tc, device="cpu"))
    for name in ("classes_", "class_count_", "class_prior_", "theta_", "var_"):
        a, b = getattr(jm, name), getattr(tm, name)
        assert b.dtype.__name__ == a.dtype.__name__ and b.split is None, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), **F32, err_msg=name)
    assert tm.epsilon_ == pytest.approx(jm.epsilon_, rel=1e-5)
    xq, _ = _blobs(seed=1, n=29)
    jq, tq = ht.array(xq, split=split, comm=jc), htt.array(xq, split=split, comm=tc, device="cpu")
    a, b = jm.predict(jq), tm.predict(tq)
    assert b.split == a.split and b.dtype.__name__ == a.dtype.__name__
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    a, b = jm.predict_log_proba(jq), tm.predict_log_proba(tq)
    assert b.split == a.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-4)
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()] or split is None
    np.testing.assert_allclose(tm.predict_proba(tq).numpy(), np.exp(a.numpy()), rtol=1e-4, atol=1e-6)
    assert tm.score(tq, htt.array(tm.predict(tq).numpy(), split=split, comm=tc, device="cpu")) == 1.0


@pytest.mark.parametrize("n", (1, 4))
def test_partial_fit_weights_priors_and_classes(ht, n):
    x, y = _blobs(n=80, dtype=np.float64)
    jc, tc = _pair(ht, n)
    w = np.random.default_rng(2).uniform(0.5, 2.0, size=80)
    kw = dict(priors=np.array([0.2, 0.3, 0.4, 0.1]), var_smoothing=1e-6)
    jm, tm = ht.naive_bayes.GaussianNB(**kw), htt.naive_bayes.GaussianNB(**kw)
    cls = np.array([0, 1, 2, 7], np.int32)
    for lo in range(0, 80, 20):
        xs, ys, ws = x[lo : lo + 20], y[lo : lo + 20], w[lo : lo + 20]
        jm.partial_fit(ht.array(xs, split=0, comm=jc), ht.array(ys, split=0, comm=jc), classes=cls,
                       sample_weight=ht.array(ws, split=0, comm=jc))
        tm.partial_fit(htt.array(xs, split=0, comm=tc, device="cpu"), htt.array(ys, split=0, comm=tc, device="cpu"),
                       classes=cls, sample_weight=htt.array(ws, split=0, comm=tc, device="cpu"))
    for name in ("classes_", "class_count_", "class_prior_", "theta_", "var_"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), getattr(jm, name).numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    assert tm.epsilon_ == pytest.approx(jm.epsilon_, rel=1e-12)
    jq, tq = ht.array(x, split=0, comm=jc), htt.array(x, split=0, comm=tc, device="cpu")
    np.testing.assert_array_equal(tm.predict(tq).numpy(), jm.predict(jq).numpy())
    np.testing.assert_allclose(tm.predict_log_proba(tq).numpy(), jm.predict_log_proba(jq).numpy(), rtol=1e-12,
                               atol=1e-9)
    # four batches equal one fit (the JAX tests' tolerances)
    xf, yf = _blobs(n=80)
    whole = htt.naive_bayes.GaussianNB().fit(htt.array(xf, split=0, comm=tc, device="cpu"),
                                             htt.array(yf, split=0, comm=tc, device="cpu"))
    inc = htt.naive_bayes.GaussianNB()
    for lo in range(0, 80, 20):
        inc.partial_fit(htt.array(xf[lo : lo + 20], split=0, comm=tc, device="cpu"),
                        htt.array(yf[lo : lo + 20], split=0, comm=tc, device="cpu"), classes=np.array([0, 1, 2]))
    np.testing.assert_allclose(inc.theta_.numpy(), whole.theta_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(inc.var_.numpy(), whole.var_.numpy(), rtol=1e-3)


def test_offset_float32_variance_is_centred():
    """At an offset of 1e4 E[x²] − mean² cancels in float32; the centred
    form keeps the variances."""
    rng = np.random.default_rng(4)
    y = np.repeat(np.arange(2, dtype=np.int32), 500)
    x = (1e4 + rng.normal(size=(1000, 3)) * 0.01 + y[:, None]).astype(np.float32)
    m = htt.naive_bayes.GaussianNB().fit(htt.array(x, split=0, comm=htt.MeshComm(4), device="cpu"),
                                         htt.array(y, split=0, comm=htt.MeshComm(4), device="cpu"))
    want = np.stack([x[y == c].astype(np.float64).var(axis=0) for c in (0, 1)])
    np.testing.assert_allclose(m.var_.numpy(), want, rtol=0.05)


def test_no_samples_by_classes_by_features_buffer(monkeypatch):
    """At 1e5 x 16 with 8 classes one (n, c, f) f32 buffer is 51 MB; no
    torch op of fit or predict_proba may allocate a quarter of it (the
    likelihood's blocks hold 2^18 elements here, the moments' 2^14 rows)."""
    from torch.profiler import ProfilerActivity, profile

    n, f, c = 100_000, 16, 8
    g = torch.Generator().manual_seed(0)
    y = torch.randint(0, c, (n,), generator=g)
    x = torch.randn(n, f, generator=g) + y[:, None].float() * 3
    monkeypatch.setattr(gnb_mod, "_MOMENT_ROWS", 1 << 14)
    monkeypatch.setattr(gnb_mod, "_JLL_ELEMENTS", 1 << 18)
    mesh = htt.MeshComm(2)
    xd, yd = htt.array(x, split=0, comm=mesh, device="cpu"), htt.array(y, split=0, comm=mesh, device="cpu")
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        m = htt.naive_bayes.GaussianNB().fit(xd, yd)
        p = m.predict_proba(xd)
    biggest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < biggest < n * c * f * 4 // 4
    assert tuple(p.shape) == (n, c)


@pytest.mark.parametrize("n", MESHES)
def test_converter(ht, n):
    x, y = _blobs(seed=5)
    jc, tc = _pair(ht, n)
    jm = ht.naive_bayes.GaussianNB().fit(ht.array(x, split=0, comm=jc), ht.array(y, split=0, comm=jc))
    tm = htt.naive_bayes.gaussiannb_from_state(
        jm.classes_.numpy(), jm.theta_.numpy(), jm.var_.numpy(), jm.class_prior_.numpy(), jm.class_count_.numpy(),
        jm.epsilon_, device="cpu", comm=tc)
    jq, tq = ht.array(x, split=0, comm=jc), htt.array(x, split=0, comm=tc, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(tq).numpy(), jm.predict_proba(jq).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.predict(tq).numpy(), jm.predict(jq).numpy())
    # fit_stream is ported (tests/test_torch_stream.py): no source raises as in heat_tpu
    for m in (tm, jm):
        with pytest.raises(TypeError, match="cannot stream"):
            m.fit_stream(None, None)
    with pytest.raises(RuntimeError):
        htt.naive_bayes.GaussianNB().predict(tq)


def test_logsumexp(ht):
    jc, tc = _pair(ht, 4)
    jm, tm = ht.naive_bayes.GaussianNB(), htt.naive_bayes.GaussianNB()
    a = np.random.default_rng(6).normal(size=(7, 3)) * 30
    for axis, keepdims in ((None, False), (0, True), (1, False)):
        want = jm.logsumexp(ht.array(a, split=0, comm=jc), axis=axis, keepdims=keepdims)
        got = tm.logsumexp(htt.array(a, split=0, comm=tc, device="cpu"), axis=axis, keepdims=keepdims)
        assert got.split == want.split and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    got, sign = tm.logsumexp(htt.array(a, comm=tc, device="cpu"), axis=1, b=-np.ones(3), return_sign=True)
    want, wsign = jm.logsumexp(ht.array(a, comm=jc), axis=1, b=-np.ones(3), return_sign=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(sign.numpy(), wsign.numpy())


# ---------------------------------------------------------- on the card
@pytest.mark.gpu
def test_card_equals_cpu(cuda):
    g = torch.Generator().manual_seed(7)
    y = torch.randint(0, 4, (50_000,), generator=g)
    x = torch.randn(50_000, 32, generator=g) + y[:, None].float() * 2
    mesh = htt.MeshComm(4)
    a = htt.naive_bayes.GaussianNB().fit(htt.array(x.to(cuda), split=0, comm=mesh), htt.array(y.to(cuda), split=0, comm=mesh))
    b = htt.naive_bayes.GaussianNB().fit(htt.array(x, split=0, comm=mesh, device="cpu"),
                                         htt.array(y, split=0, comm=mesh, device="cpu"))
    np.testing.assert_allclose(a.theta_.numpy(), b.theta_.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.var_.numpy(), b.var_.numpy(), rtol=1e-4)
    la = a.predict_log_proba(htt.array(x[:10000].to(cuda), split=0, comm=mesh)).numpy()
    lb = b.predict_log_proba(htt.array(x[:10000], split=0, comm=mesh, device="cpu")).numpy()
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
