"""KMeans: heat_tpu_torch against heat_tpu on the CPU, and the port on the
card.

With explicit initial centres on well-separated f32 data both packages run
the same Lloyd iterations, so ``labels_``, ``n_iter_`` and ``predict`` must
be equal and ``cluster_centers_``/``inertia_`` agree to rtol 1e-5 (the sums
are taken in different orders).  The data sit near the origin so the
distance expansion's cancellation stays far below that tolerance.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import cdist as k1


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests (the tests that
    need only the card run without it)."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
CENTRES = np.array([[-3.0, -3.0, 0.0, 1.0], [3.0, -2.0, 1.0, 0.0], [0.0, 3.0, -1.0, -1.0]], np.float32)


def _blobs(per=40, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(c, 0.7, size=(per, CENTRES.shape[1])) for c in CENTRES])
    return x[rng.permutation(len(x))].astype(dtype)


def _init(x, seed=1):
    rng = np.random.default_rng(seed)
    return x[rng.choice(len(x), size=len(CENTRES), replace=False)]


def _fit_both(ht, x, c0, n, split=0, **kw):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.cluster.KMeans(n_clusters=len(c0), init=ht.array(c0, comm=jc), **kw)
    a.fit(ht.array(x, split=split, comm=jc))
    b = htt.cluster.KMeans(n_clusters=len(c0), init=htt.array(c0, comm=tc, device="cpu"), **kw)
    b.fit(htt.array(x, split=split, comm=tc, device="cpu"))
    return a, b


@pytest.fixture
def cpu_default():
    htt.use_device("cpu")
    yield
    htt.use_device("gpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [0, None])
def test_fit_matches_jax_with_explicit_init(ht, n, split):
    x = _blobs()
    a, b = _fit_both(ht, x, _init(x), n, split=split, max_iter=30, tol=1e-4)
    assert b.n_iter_ == a.n_iter_
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    assert b.labels_.split == a.labels_.split
    assert b.cluster_centers_.dtype is htt.float32
    np.testing.assert_allclose(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-5)


@pytest.mark.parametrize("n", MESHES)
def test_predict_matches_jax(ht, n):
    x = _blobs()
    a, b = _fit_both(ht, x, _init(x), n, max_iter=30, tol=1e-4)
    new = _blobs(per=7, seed=9)
    pa = a.predict(ht.array(new, split=0, comm=ht.parallel.mesh.local_mesh(n)))
    pb = b.predict(htt.array(new, split=0, comm=htt.MeshComm(n), device="cpu"))
    assert pb.shape == pa.shape == (len(new), 1)
    np.testing.assert_array_equal(pb.numpy(), pa.numpy())
    assert [s.shape for s in pb.lshards()] == [s.shape for s in pa.lshards()]


@pytest.mark.parametrize("n", MESHES)
def test_tol_minus_one_runs_max_iter(ht, n):
    x = _blobs()
    a, b = _fit_both(ht, x, _init(x), n, max_iter=7, tol=-1.0)
    assert a.n_iter_ == b.n_iter_ == 7
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-5)


def test_integer_input_is_cast_to_float32(ht):
    x = np.round(_blobs() * 4).astype(np.int32)
    c0 = _init(x).astype(np.float32)
    a, b = _fit_both(ht, x, c0, 4, max_iter=30, tol=1e-4)
    assert b.n_iter_ == a.n_iter_
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    np.testing.assert_allclose(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), rtol=1e-5)


def test_empty_cluster_keeps_its_centre(ht):
    x = _blobs()
    c0 = np.concatenate([_init(x)[:2], np.full((1, 4), 100.0, np.float32)])
    a, b = _fit_both(ht, x, c0, 4, max_iter=5, tol=1e-4)
    np.testing.assert_allclose(b.cluster_centers_.numpy()[2], 100.0)
    np.testing.assert_allclose(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), rtol=1e-5)


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_seeded_init_is_deterministic_and_mesh_invariant(init):
    x = _blobs(seed=3)
    fits = []
    for n in MESHES + (4,):
        km = htt.cluster.KMeans(n_clusters=3, init=init, max_iter=20, random_state=5)
        km.fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu"))
        fits.append(km)
    for km in fits[1:]:
        np.testing.assert_array_equal(km.labels_.numpy(), fits[0].labels_.numpy())
        np.testing.assert_allclose(km.cluster_centers_.numpy(), fits[0].cluster_centers_.numpy(), rtol=1e-5, atol=1e-6)
    if init == "kmeans++":
        # distance-weighted seeding finds the three blobs on this data
        found = np.sort(fits[0].cluster_centers_.numpy()[:, 0])
        np.testing.assert_allclose(found, np.sort(CENTRES[:, 0]), atol=0.3)


def _kmeanspp_against_exact_cdf(dev, rows, n):
    """kmeans++ picks the row where the uniform draw falls in the CDF of the
    distances to the nearest chosen centre; the picks must be those of the
    CDF summed in float64 by numpy over the same float32 distances."""
    from heat_tpu_torch.cluster import _kcluster

    k = 4
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(rows, 2, generator=gen, device=dev)
    us = torch.tensor([0.1234, 0.8765, 0.4321, 0.5678], device=dev)
    got = _kcluster._kmeanspp_init(list(torch.tensor_split(x, n)), us, k)
    chosen = [min(int(0.1234 * rows), rows - 1)]
    d = k1.cdist(x, x[chosen[0]][None], sqrt=True)[:, 0]
    for j in range(1, k):
        d64 = d.cpu().numpy().astype(np.float64)
        cdf = np.cumsum(d64) / d64.sum()
        chosen.append(min(int(np.searchsorted(cdf, np.float64(us[j].item()))), rows - 1))
        d = torch.minimum(d, k1.cdist(x, x[chosen[j]][None], sqrt=True)[:, 0])
    np.testing.assert_array_equal(got.cpu().numpy(), x[chosen].cpu().numpy())


@pytest.mark.parametrize("n", [1, 4])
def test_kmeanspp_draws_from_the_exact_distance_cdf(n):
    _kmeanspp_against_exact_cdf(torch.device("cpu"), 1_000_000, n)


@pytest.mark.gpu
def test_kmeanspp_on_card_draws_from_the_exact_distance_cdf(cuda):
    # at 2e7 rows a row's share of the mass is about one float32 ulp of the
    # running sum, so a float32 CDF on the card drifts by many rows
    _kmeanspp_against_exact_cdf(cuda, 20_000_000, 1)


@pytest.mark.parametrize("n", MESHES)
def test_jax_fitted_state_carried_across(ht, n):
    x = _blobs(seed=4)
    a = ht.cluster.KMeans(n_clusters=3, init="kmeans++", max_iter=30, random_state=2)
    a.fit(ht.array(x, split=0))
    b = htt.cluster.kmeans_from_state(
        a.cluster_centers_.numpy(), a.n_iter_, a.inertia_, n_clusters=3,
        device="cpu", comm=htt.MeshComm(n),
    )
    assert b.n_iter_ == a.n_iter_ and b.inertia_ == a.inertia_
    new = _blobs(per=11, seed=8)
    pa = a.predict(ht.array(new, split=0))
    pb = b.predict(htt.array(new, split=0, comm=htt.MeshComm(n), device="cpu"))
    np.testing.assert_array_equal(pb.numpy(), pa.numpy())


def test_update_centroids_matches_jax(ht):
    x = _blobs()
    a, b = _fit_both(ht, x, _init(x), 4, max_iter=2, tol=-1.0)
    ua = a._update_centroids(ht.array(x, split=0, comm=ht.parallel.mesh.local_mesh(4)), a.labels_)
    ub = b._update_centroids(htt.array(x, split=0, comm=htt.MeshComm(4), device="cpu"), b.labels_)
    np.testing.assert_allclose(ub.numpy(), ua.numpy(), rtol=1e-5)


def test_half_precision_fit_goes_through_k1(monkeypatch):
    # every distance of the fit (kmeans++, Lloyd, labels) is K1 on the bf16
    # blocks and bf16 centres themselves: no f32 copy of the data
    seen = []
    real = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda a, b, sqrt=True: seen.append((a.dtype, b.dtype)) or real(a, b, sqrt))
    k, iters, n = 3, 4, 4
    x = htt.array(_blobs(), dtype=htt.bfloat16, split=0, comm=htt.MeshComm(n), device="cpu")
    km = htt.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=iters, tol=-1.0, random_state=0).fit(x)
    assert km.n_iter_ == iters and km.cluster_centers_.dtype is htt.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16)] * (n * (k + iters + 1))


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert htt.get_device() == htt.gpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        htt.array(_blobs(), split=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        htt.random.rand(3, 3)


def test_use_device_cpu_runs_the_fit(cpu_default):
    km = htt.cluster.KMeans(n_clusters=3, init="kmeans++", max_iter=10, random_state=0)
    km.fit(htt.array(_blobs(), split=0))
    assert km.cluster_centers_.device == htt.cpu
    assert km.cluster_centers_.shards[0].device.type == "cpu"


def test_predict_before_fit_raises():
    with pytest.raises(RuntimeError, match="not fitted"):
        htt.cluster.KMeans(n_clusters=3).predict(htt.array(_blobs(), device="cpu"))


# ------------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_fit_on_card_goes_through_k1(cuda):
    x = _blobs()
    k, max_iter, n = 3, 5, 4
    k1.launches = 0
    km = htt.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=max_iter, tol=-1.0, random_state=0)
    km.fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="gpu"))
    # kmeans++ seeding, the Lloyd steps and the labels pass, per position
    assert k1.launches == n * (k + max_iter + 1)
    assert km.n_iter_ == max_iter
    labels = km.predict(htt.array(x, split=0, comm=htt.MeshComm(n), device="gpu"))
    assert k1.launches == n * (k + max_iter + 2)
    # the same fit on the CPU (the plain version) lands on the same centres
    ref = htt.cluster.KMeans(n_clusters=k, init=htt.array(km.cluster_centers_.numpy(), device="cpu"), max_iter=1, tol=-1.0)
    ref.fit(htt.array(x, split=0, device="cpu"))
    np.testing.assert_array_equal(labels.numpy(), ref.labels_.numpy())
    np.testing.assert_allclose(ref.cluster_centers_.numpy(), km.cluster_centers_.numpy(), rtol=1e-5, atol=1e-6)
