"""KMedians and KMedoids: heat_tpu_torch against heat_tpu on the CPU, and
the port on the card.

The per-cluster medians are exact selections (two order statistics of each
cluster's column, averaged in the data's type), so the port's must equal
heat_tpu's bit for bit on the same labels.  With explicit initial centres
on well-separated data both packages run the same iterations: ``labels_``,
``n_iter_``, ``predict`` and the KMedians centres must be equal; KMedoids'
snap to the nearest sample resolves near-ties by rounding, so its parity
data are integer-valued points whose nearest sample is separated by far
more than K1's error bound.  ``inertia_`` (a sum of L1 row minima taken in
other orders) agrees to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.cluster import _kcluster
from heat_tpu_torch.ops import cdist as k1
from heat_tpu_torch.spatial import distance


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests (the tests that
    need only the card run without it)."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
CENTRES = np.array([[-6.0, -6.0, 0.0], [6.0, -5.0, 2.0], [0.0, 6.0, -3.0]], np.float32)
ESTIMATORS = ("KMedians", "KMedoids")


def _blobs(per=40, seed=0, dtype=np.float32, integer=False):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(c, 1.0, size=(per, CENTRES.shape[1])) for c in CENTRES])
    if integer:
        x = np.round(x * 2)
    return x[rng.permutation(len(x))].astype(dtype)


def _init(x, seed=1):
    rng = np.random.default_rng(seed)
    return x[rng.choice(len(x), size=len(CENTRES), replace=False)]


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _fit_both(ht, name, x, c0, n, split=0, dtype=None, **kw):
    jc, tc = _pair(ht, n)
    a = getattr(ht.cluster, name)(n_clusters=len(c0), init=ht.array(c0, comm=jc), **kw)
    a.fit(ht.array(x, split=split, comm=jc, dtype=dtype))
    b = getattr(htt.cluster, name)(n_clusters=len(c0), init=htt.array(c0, comm=tc, device="cpu"), **kw)
    b.fit(htt.array(x, split=split, comm=tc, device="cpu", dtype=dtype))
    return a, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------- the medians
def _to_jax(a, dtype):
    import jax.numpy as jnp

    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        return jnp.asarray(a.astype(ml_dtypes.bfloat16))
    return jnp.asarray(a.astype(dtype))


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        ml_dtypes = pytest.importorskip("ml_dtypes")
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# counts per cluster: odd, even, one, two, and an empty cluster
MEDIAN_CASES = {
    "odd and even": [7, 10, 1, 2],
    "with an empty cluster": [9, 0, 4, 3],
}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MEDIAN_CASES))
def test_masked_medians_bitwise(ht, n, dtype, case):
    from heat_tpu.cluster import _kcluster as jk

    counts = MEDIAN_CASES[case]
    k = len(counts)
    rng = np.random.default_rng(5)
    labels = rng.permutation(np.repeat(np.arange(k), counts))
    x = rng.normal(size=(len(labels), 5)) * 10
    fallback = rng.normal(size=(k, 5))
    want = np.asarray(jk._masked_medians(_to_jax(x, dtype), _to_jax(labels, np.int32), k, _to_jax(fallback, dtype)))
    tt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tt)
    blocks = list(torch.tensor_split(xt, n))
    labs = list(torch.tensor_split(torch.from_numpy(labels), n))
    got = _kcluster._masked_medians(blocks, labs, k, torch.from_numpy(fallback).to(tt))
    assert got.dtype == tt
    np.testing.assert_array_equal(_host(got).view(np.uint8), want.view(np.uint8))


# ------------------------------------------------------------ the estimators
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("name", ESTIMATORS)
def test_fit_matches_jax_with_explicit_init(ht, name, n, split):
    x = _blobs(integer=name == "KMedoids")
    a, b = _fit_both(ht, name, x, _init(x), n, split=split, max_iter=30)
    assert b.n_iter_ == a.n_iter_ > 1
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    assert b.labels_.split == a.labels_.split and b.labels_.shape == (len(x), 1)
    assert b.cluster_centers_.dtype is htt.float32 and b.cluster_centers_.split is None
    np.testing.assert_array_equal(b.cluster_centers_.numpy(), a.cluster_centers_.numpy())
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-5)
    assert isinstance(b.inertia_, float)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", ESTIMATORS)
def test_predict_matches_jax(ht, name, n):
    x = _blobs(integer=name == "KMedoids")
    a, b = _fit_both(ht, name, x, _init(x), n, max_iter=30)
    new = _blobs(per=7, seed=9)
    pa = a.predict(ht.array(new, split=0, comm=ht.parallel.mesh.local_mesh(n)))
    pb = b.predict(htt.array(new, split=0, comm=htt.MeshComm(n), device="cpu"))
    assert pb.shape == pa.shape == (len(new), 1)
    np.testing.assert_array_equal(pb.numpy(), pa.numpy())
    assert [s.shape for s in pb.lshards()] == [s.shape for s in pa.lshards()]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", ESTIMATORS)
def test_tol_minus_one_and_max_iter(ht, name, n):
    x = _blobs(integer=True)
    kw = {"max_iter": 4}
    if name == "KMedians":
        kw["tol"] = -1.0
    a, b = _fit_both(ht, name, x, _init(x), n, **kw)
    assert b.n_iter_ == a.n_iter_
    if name == "KMedians":
        assert b.n_iter_ == 4
    np.testing.assert_array_equal(b.cluster_centers_.numpy(), a.cluster_centers_.numpy())


@pytest.mark.parametrize("name", ESTIMATORS)
def test_integer_input_is_cast_to_float32(ht, name):
    x = _blobs(integer=True).astype(np.int32)
    a, b = _fit_both(ht, name, x, _init(x).astype(np.float32), 4, max_iter=30)
    assert b.cluster_centers_.dtype is htt.float32
    assert b.n_iter_ == a.n_iter_
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    np.testing.assert_array_equal(b.cluster_centers_.numpy(), a.cluster_centers_.numpy())


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", ESTIMATORS)
def test_bf16_stays_16_bit(ht, name, n):
    # integer-valued points below 256 are exact in bf16, and so are their
    # L1 distances and medians (halves of odd sums included)
    x = _blobs(integer=True)
    a, b = _fit_both(ht, name, x, _init(x), n, dtype="bfloat16", max_iter=30)
    assert b.cluster_centers_.dtype is htt.bfloat16
    assert b.n_iter_ == a.n_iter_
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    np.testing.assert_array_equal(
        b.cluster_centers_.numpy().astype(np.float32), a.cluster_centers_.numpy().astype(np.float32)
    )
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-2)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_empty_cluster_keeps_its_centre(ht, name):
    x = _blobs(integer=True)
    c0 = np.concatenate([_init(x)[:2], np.full((1, 3), 100.0, np.float32)])
    a, b = _fit_both(ht, name, x, c0, 4, max_iter=5)
    np.testing.assert_array_equal(b.cluster_centers_.numpy()[2], 100.0)
    np.testing.assert_array_equal(b.cluster_centers_.numpy(), a.cluster_centers_.numpy())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", ESTIMATORS)
def test_update_centroids_matches_jax(ht, name, n):
    x = _blobs(integer=True)
    jc, tc = _pair(ht, n)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, size=(len(x), 1))
    labels[labels == 2] = 1  # cluster 2 empty: its old centre stays
    c0 = _init(x)
    a = getattr(ht.cluster, name)(n_clusters=3, init=ht.array(c0, comm=jc))
    a._cluster_centers = ht.array(c0, comm=jc)
    b = getattr(htt.cluster, name)(n_clusters=3, init=htt.array(c0, comm=tc, device="cpu"))
    b._cluster_centers = htt.array(c0, comm=tc, device="cpu")
    ua = a._update_centroids(ht.array(x, split=0, comm=jc), ht.array(labels, split=0, comm=jc))
    ub = b._update_centroids(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(labels, split=0, comm=tc, device="cpu"))
    assert ub.shape == ua.shape and ub.split is None
    np.testing.assert_array_equal(ub.numpy(), ua.numpy())
    np.testing.assert_array_equal(ub.numpy()[2], c0[2])


@pytest.mark.parametrize("n", MESHES)
def test_kmedoids_snaps_to_samples_on_integer_points(ht, n):
    # integer points on a coarse grid: every median's nearest sample is
    # nearer by at least 1 in d2 than any other, far above K1's bound
    rng = np.random.default_rng(11)
    x = np.unique(rng.integers(-30, 30, size=(300, 3)), axis=0).astype(np.float32)
    x = x[rng.permutation(len(x))]
    c0 = x[:4]
    a, b = _fit_both(ht, "KMedoids", x, c0, n, max_iter=50)
    got = b.cluster_centers_.numpy()
    np.testing.assert_array_equal(got, a.cluster_centers_.numpy())
    assert b.n_iter_ == a.n_iter_
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in got.tolist())


def test_init_names_and_kmedoids_tol():
    assert htt.cluster.KMedians(init="kmedians++").init == "probability_based"
    assert htt.cluster.KMedoids(init="kmedoids++").init == "probability_based"
    assert htt.cluster.KMedoids().tol == 0.0
    with pytest.raises(RuntimeError, match="not fitted"):
        htt.cluster.KMedians(n_clusters=3).predict(htt.array(_blobs(), device="cpu"))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_seeded_plusplus_is_mesh_invariant(name):
    x = _blobs(seed=3, integer=True)
    init = name.lower() + "++"
    fits = []
    for n in MESHES:
        est = getattr(htt.cluster, name)(n_clusters=3, init=init, max_iter=20, random_state=5)
        fits.append(est.fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu")))
    for est in fits[1:]:
        np.testing.assert_array_equal(est.labels_.numpy(), fits[0].labels_.numpy())
        np.testing.assert_array_equal(est.cluster_centers_.numpy(), fits[0].cluster_centers_.numpy())


@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("n", [1, 4])
def test_k1_calls_one_snap_an_iteration_a_position(monkeypatch, name, n):
    calls = []
    real = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda x, y, sqrt=True: calls.append(tuple(y.shape)) or real(x, y, sqrt=sqrt))
    x = _blobs(integer=True)
    est = getattr(htt.cluster, name)(n_clusters=3, init=htt.array(_init(x), device="cpu"), max_iter=30)
    est.fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu"))
    est.predict(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu"))
    snaps = est.n_iter_ * n if name == "KMedoids" else 0
    assert calls == [(3, 3)] * snaps


def test_median_loop_never_allocates_n_k_f(monkeypatch):
    """At 2e5 x 16 against 8 centres one (n, k, f) f32 buffer is 102 MB;
    no torch op of the loop may allocate that much (the L1 blocks hold a
    2^20-element slice here)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(distance, "_L1_ELEMENTS", 1 << 20)
    n, f, k = 200_000, 16, 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, f, generator=gen)
    centers = x[:k].clone()
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        _kcluster._median_loop([x], centers, k, 2, -1.0, snap_to_sample=True)
    biggest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < biggest < n * k * f * 4
    # the biggest is the grouped copy of the rows (n x f), or a block
    assert biggest <= n * f * 8


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 5])
def test_k1_at_odd_widths_against_plain(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    for m, kk in [(1_000_003, 4), (4097, 1), (33, 9)]:
        x = torch.randn(m, d, generator=gen, device=cuda) + 4.0
        y = torch.randn(kk, d, generator=gen, device=cuda) + 4.0
        for sqrt in (False, True):
            got, want = k1.cdist(x, y, sqrt=sqrt), k1.reference_cdist(x, y, sqrt=sqrt)
            g2, w2 = (got**2, want**2) if sqrt else (got, want)
            scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            assert float(((g2 - w2).abs() / scale).max()) <= 1e-5
        for dt in (torch.bfloat16, torch.float16):
            xh, yh = x.to(dt), y.to(dt)
            got, want = k1.cdist(xh, yh, sqrt=False), k1.reference_cdist(xh, yh, sqrt=False)
            scale = (xh.float() ** 2).sum(1)[:, None] + (yh.float() ** 2).sum(1)[None, :]
            assert float(((got - want).abs() / scale).max()) <= 1e-5


@pytest.mark.gpu
def test_kmedoids_on_card_launches_k1_once_an_iteration(cuda):
    x = _blobs(per=2000, integer=True)
    k1.launches = 0
    est = htt.cluster.KMedoids(n_clusters=3, init=htt.array(_init(x), device="gpu"), max_iter=30)
    est.fit(htt.array(x, split=0, device="gpu"))
    assert k1.launches == est.n_iter_ > 1
    k1.launches = 0
    htt.cluster.KMedoids(n_clusters=3, init="kmedoids++", max_iter=4, random_state=1).fit(
        htt.array(x, split=0, device="gpu")
    )
    assert 3 < k1.launches <= 3 + 4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ESTIMATORS)
def test_card_equals_cpu_on_a_small_input(cuda, name):
    x = _blobs(per=500, integer=name == "KMedoids")
    mesh = htt.MeshComm(4)
    fits = [
        getattr(htt.cluster, name)(n_clusters=3, init=htt.array(_init(x), device=dev), max_iter=30).fit(
            htt.array(x, split=0, comm=mesh, device=dev)
        )
        for dev in ("gpu", "cpu")
    ]
    card, cpu = fits
    assert card.n_iter_ == cpu.n_iter_
    np.testing.assert_array_equal(card.labels_.numpy(), cpu.labels_.numpy())
    np.testing.assert_array_equal(card.cluster_centers_.numpy(), cpu.cluster_centers_.numpy())
    np.testing.assert_allclose(card.inertia_, cpu.inertia_, rtol=1e-5)
