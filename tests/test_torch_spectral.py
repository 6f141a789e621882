"""The Spectral path: heat_tpu_torch's ``knn_graph``, Laplacians, Lanczos,
CG, ``rbf`` and ``Spectral`` against heat_tpu on the CPU at port meshes of
1, 4 and 8 positions.

Tolerances, with their reasons:

* the k-NN graph: the same structure (the data keeps every row's k-th and
  (k+1)-th neighbour distances apart, so no tie decides an edge), values
  within rel 1e-5 (f32 distances by the expansion, summed in other orders);
* Laplacians: rel 1e-6 of the largest entry (one more rounding per entry);
* Lanczos: dense f64 with a given start vector, T within 1e-10; sparse f32,
  the alphas and betas within rel 1e-4 at n = 300, m ≤ 8 (f32 drift grows
  with m, so the comparison stays shallow);
* Spectral: labels equal up to a permutation of the clusters, the
  embedding's first ``n_clusters`` columns within 1e-3 up to sign (the two
  eigensolvers fix the signs of eigenvectors differently).

The blobs of the Spectral tests lie close enough for the graph to be
connected, and ``n_lanczos`` is large enough for the two smallest
eigenvectors to converge: the clustering is then well posed, so both
packages find the blobs whatever their KMeans's random start.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import spmv as k6


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)


def _points(n=120, d=3, seed=0, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def _blobs(n=400, d=4, sep=3.0, seed=3):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, d)), rng.normal(sep, 1, (n - n // 2, d))]).astype(np.float32)
    return x, np.r_[np.zeros(n // 2), np.ones(n - n // 2)]


def _meshes(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _same_partition(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# ----------------------------------------------------------------- k-NN graph
def test_graph_data_has_no_neighbour_ties():
    x = _points().astype(np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    s = np.sort(d2, axis=1)
    assert np.min((s[:, 6] - s[:, 5]) / s[:, 6]) > 1e-4


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("weights,symmetrize", [("rbf", True), ("connectivity", True), ("distance", False)])
def test_knn_graph_equals_jax(ht, n, weights, symmetrize):
    x = _points()
    jc, tc = _meshes(ht, n)
    a = ht.sparse.knn_graph(ht.array(x, split=0, comm=jc), 6, weights=weights, sigma=0.7, symmetrize=symmetrize)
    b = htt.sparse.knn_graph(htt.array(x, split=0, comm=tc, device="cpu"), 6, weights=weights, sigma=0.7, symmetrize=symmetrize)
    assert b.shape == a.shape and b.split == a.split == 0 and b.nnz == a.nnz and b.dtype is htt.float32
    assert b._graph_meta == {"knn_k": 6, "weights": weights, "has_diagonal": True}
    for r in range(n):
        (da, ia, pa), (db, ib, pb) = a.shard_csr(r), b.shard_csr(r)
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_allclose(db, da, rtol=1e-5, atol=1e-6)
    if not symmetrize:
        assert np.all(np.diff(b.to_scipy().indptr) == 7)  # k edges and the diagonal


def test_knn_graph_small_inputs():
    b = htt.sparse.knn_graph(_points(n=5), 10, split=None, device="cpu")
    assert b.nnz == 25 and b.split is None  # k clamps to n - 1
    b = htt.sparse.knn_graph(_points(n=1), 3, device="cpu")
    assert b.nnz == 1 and b.to_scipy()[0, 0] == 0
    with pytest.raises(ValueError):
        htt.sparse.knn_graph(_points(n=5), 2, weights="cosine", device="cpu")


# ----------------------------------------------------------------- Laplacians
def _graph(seed=1, n=60, diagonal=True):
    rng = np.random.default_rng(seed)
    w = scipy.sparse.random(n, n, density=0.1, random_state=rng, dtype=np.float64)
    w = w.maximum(w.T).tolil()
    w.setdiag(0.0)
    w[5, :] = 0  # an isolated vertex: degree 0
    w[:, 5] = 0
    w = w.tocsr()
    w.eliminate_zeros()
    if diagonal:
        c = w.tocoo()
        w = scipy.sparse.csr_matrix(
            (np.r_[c.data, np.zeros(n)], (np.r_[c.row, np.arange(n)], np.r_[c.col, np.arange(n)])), shape=(n, n)
        )
    return w.astype(np.float32)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("definition", ["norm_sym", "simple"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("diagonal", [True, False])
def test_laplacian_sparse_equals_jax(ht, n, definition, weighted, diagonal):
    w = _graph(diagonal=diagonal)
    jc, tc = _meshes(ht, n)
    a = ht.graph.laplacian_sparse(ht.sparse.sparse_csr_matrix(w, split=0, comm=jc), definition, weighted)
    b = htt.graph.laplacian_sparse(htt.sparse.sparse_csr_matrix(w, split=0, comm=tc, device="cpu"), definition, weighted)
    assert b.dtype is htt.float32 and b.split == 0 and b.nnz == a.nnz
    la, lb = a.to_scipy(), b.to_scipy()
    np.testing.assert_array_equal(lb.indices, la.indices)
    np.testing.assert_array_equal(lb.indptr, la.indptr)
    np.testing.assert_allclose(lb.data, la.data, rtol=0, atol=1e-6 * np.abs(la.data).max())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("definition", ["norm_sym", "simple"])
@pytest.mark.parametrize("mode,key", [("fully_connected", "upper"), ("eNeighbour", "upper"), ("eNeighbour", "lower")])
def test_dense_laplacian_equals_jax(ht, n, definition, mode, key):
    x = _points(n=50, seed=2)
    jc, tc = _meshes(ht, n)
    kw = dict(definition=definition, mode=mode, threshold_key=key, threshold_value=0.5, weighted=(key == "upper"))
    a = ht.graph.Laplacian(lambda v: ht.spatial.rbf(v, sigma=0.8), **kw).construct(ht.array(x, split=0, comm=jc))
    b = htt.graph.Laplacian(lambda v: htt.spatial.rbf(v, sigma=0.8), **kw).construct(
        htt.array(x, split=0, comm=tc, device="cpu")
    )
    assert b.shape == a.shape and b.split == a.split
    la = a.numpy()
    np.testing.assert_allclose(b.numpy(), la, rtol=0, atol=1e-6 * np.abs(la).max())


def test_laplacian_options_are_checked():
    with pytest.raises(NotImplementedError):
        htt.graph.Laplacian(lambda v: v, definition="norm_rw")
    with pytest.raises(NotImplementedError):
        htt.graph.Laplacian(lambda v: v, mode="kNN")
    with pytest.raises(ValueError):
        htt.graph.Laplacian(lambda v: v, threshold_key="middle")
    a = htt.sparse.sparse_csr_matrix(np.ones((3, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        htt.graph.laplacian_sparse(a)


@pytest.mark.parametrize("n", MESHES)
def test_rbf_equals_jax(ht, n):
    x, y = _points(n=30, seed=3), _points(n=7, seed=4)
    jc, tc = _meshes(ht, n)
    a = ht.spatial.rbf(ht.array(x, split=0, comm=jc), ht.array(y, comm=jc), sigma=0.6)
    b = htt.spatial.rbf(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(y, comm=tc, device="cpu"), sigma=0.6)
    assert b.shape == a.shape and b.split == a.split and b.dtype is htt.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- solvers
def _spd(n=40, seed=5):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


@pytest.mark.parametrize("n", MESHES)
def test_lanczos_dense_f64_equals_jax(ht, n):
    from heat_tpu.core.linalg import solver as jsolver

    a = _spd()
    v0 = np.random.default_rng(6).normal(size=40)
    jc, tc = _meshes(ht, n)
    Va, Ta = jsolver.lanczos(ht.array(a, split=0, comm=jc), 12, v0=ht.array(v0, comm=jc))
    Vb, Tb = htt.lanczos(htt.array(a, split=0, comm=tc, device="cpu"), 12, v0=htt.array(v0, comm=tc, device="cpu"))
    assert Vb.shape == Va.shape == (40, 12) and Vb.split == Va.split == 0 and Tb.split is None
    np.testing.assert_allclose(Tb.numpy(), Ta.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Vb.numpy(), Va.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", MESHES)
def test_lanczos_sparse_f32_equals_jax(ht, n):
    from heat_tpu.core.linalg import solver as jsolver

    x = _points(n=300, d=4, seed=7)
    jc, tc = _meshes(ht, n)
    La = ht.graph.laplacian_sparse(ht.sparse.knn_graph(ht.array(x, split=0, comm=jc), 6))
    Lb = htt.graph.laplacian_sparse(htt.sparse.knn_graph(htt.array(x, split=0, comm=tc, device="cpu"), 6))
    v0 = np.sin(np.arange(1, 301, dtype=np.float32))
    _, Ta = jsolver.lanczos(La, 8, v0=ht.array(v0, comm=jc))
    before = k6.launches
    Vb, Tb = htt.lanczos(Lb, 8, v0=htt.array(v0, comm=tc, device="cpu"))
    assert k6.launches == before and Vb.dtype is htt.float32
    ta, tb = Ta.numpy(), Tb.numpy()
    np.testing.assert_allclose(np.diag(tb), np.diag(ta), rtol=1e-4)
    np.testing.assert_allclose(np.diag(tb, 1), np.diag(ta, 1), rtol=1e-4)
    # the basis is orthonormal
    v = Vb.numpy().astype(np.float64)
    np.testing.assert_allclose(v.T @ v, np.eye(8), atol=1e-5)


def test_lanczos_breakdown_restarts_and_checks_shape():
    a = np.diag([1.0, 2.0, 3.0, 4.0])
    V, T = htt.lanczos(htt.array(a, device="cpu"), 4, v0=htt.array(np.array([1.0, 0, 0, 0]), device="cpu"))
    v = V.numpy()
    np.testing.assert_allclose(v.T @ v, np.eye(4), atol=1e-12)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(T.numpy())), [1, 2, 3, 4], atol=1e-10)
    with pytest.raises(RuntimeError):
        htt.lanczos(htt.array(np.ones((3, 4)), device="cpu"), 2)
    V_out, T_out = htt.zeros((4, 4), dtype=htt.float64, device="cpu"), htt.zeros((4, 4), dtype=htt.float64, device="cpu")
    res = htt.lanczos(htt.array(a, device="cpu"), 4, v0=htt.array(np.ones(4), device="cpu"), V_out=V_out, T_out=T_out)
    assert res[0] is V_out and res[1] is T_out


@pytest.mark.parametrize("n", MESHES)
def test_cg_equals_jax(ht, n):
    a = _spd(n=24, seed=8)
    b = np.random.default_rng(9).normal(size=24)
    jc, tc = _meshes(ht, n)
    xa = ht.linalg.cg(ht.array(a, split=0, comm=jc), ht.array(b, split=0, comm=jc), ht.zeros(24, dtype=ht.float64, comm=jc))
    xb = htt.cg(htt.array(a, split=0, comm=tc, device="cpu"), htt.array(b, split=0, comm=tc, device="cpu"),
                htt.zeros(24, dtype=htt.float64, comm=tc, device="cpu"))
    assert xb.split == xa.split == 0
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a @ xb.numpy(), b, atol=1e-8)


# ------------------------------------------------------------------ Spectral
@pytest.mark.parametrize("affinity,m", [("knn", 60), ("rbf", 30)])
@pytest.mark.parametrize("n", [1, 4])
def test_spectral_fit_equals_jax(ht, affinity, m, n):
    x, truth = _blobs()
    jc, tc = _meshes(ht, n)
    kw = dict(n_clusters=2, gamma=1.0, affinity=affinity, n_neighbors=6, n_lanczos=m)
    a = ht.cluster.Spectral(**kw).fit(ht.array(x, split=0, comm=jc))
    b = htt.cluster.Spectral(**kw).fit(htt.array(x, split=0, comm=tc, device="cpu"))
    assert b.labels_.shape == a.labels_.shape == (400, 1) and b.labels_.split == 0
    assert _same_partition(b.labels_.numpy(), a.labels_.numpy())
    assert _same_partition(b.labels_.numpy(), truth)
    if affinity == "knn":
        # the sparse path's start vector is deterministic in both packages
        _, ea, _ = a._spectral_embedding(ht.array(x, split=0, comm=jc))
        _, eb = b._spectral_embedding(htt.array(x, split=0, comm=tc, device="cpu"))
        ea, eb = np.asarray(ea)[:, :2], eb.numpy()[:, :2]
        signs = np.sign(np.sum(ea * eb, axis=0))
        np.testing.assert_allclose(eb * signs, ea, rtol=0, atol=1e-3)


def _splits_blobs(first_column, graph, truth):
    """Whether the embedding's first column separates the blobs.  The graph
    of two far blobs has two components, so that column is D^1/2 (a·1_A +
    b·1_B): divided by √degree it takes one value per blob, and a cut at its
    largest gap must give the blobs."""
    w = graph.to_scipy().tolil()
    w.setdiag(0.0)
    r = np.asarray(first_column, np.float64) / np.sqrt(np.asarray(w.tocsr().sum(axis=1)).ravel())
    o = np.sort(r)
    i = int(np.argmax(np.diff(o)))
    return _same_partition(r > (o[i] + o[i + 1]) / 2, truth)


def test_benchmark_blobs_stop_kmeans_early_in_both_packages(ht):
    """The repo's Spectral benchmark recipe (two blobs N(0, 0.3) and N(3,
    0.3) in 16 dimensions, k = 6, 32 Lanczos steps), cut to 16384 points.
    In both packages the embedding's first column splits the blobs, but the
    KMeans that ``fit`` runs on the embedding stops after one Lloyd step
    (its tol is absolute and the embedding's entries are ~n^-1/2), so its
    labels need not recover the blobs; the port is held to the embedding,
    as the reference is."""
    n = 16384
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0.0, 0.3, (n // 2, 16)), rng.normal(3.0, 0.3, (n // 2, 16))]).astype(np.float32)
    truth = np.arange(n) >= n // 2
    kw = dict(n_clusters=2, gamma=1.0, affinity="knn", n_neighbors=6, n_lanczos=32)
    # fit's two steps, with the embedding kept; seeded kmeans++ starts
    ht.random.seed(0)
    htt.random.seed(0)
    a, xa = ht.cluster.Spectral(**kw), ht.array(x, split=0)
    _, ea, _ = a._spectral_embedding(xa)
    ea = np.asarray(ea)
    a._cluster.fit(ht.array(ea[:, :2], split=0))
    b, xb = htt.cluster.Spectral(**kw), htt.array(x, split=0, device="cpu")
    _, eb = b._spectral_embedding(xb)
    b._cluster.fit(b._embed(xb, eb))
    assert a._cluster.n_iter_ == b._cluster.n_iter_ == 1
    graph = htt.sparse.knn_graph(xb, 6, sigma=0.5**0.5)
    assert _splits_blobs(ea[:, 0], graph, truth)
    assert _splits_blobs(eb[:, 0].numpy(), graph, truth)


def test_spectral_knn_on_cpu_launches_nothing_and_picks_n_clusters():
    x, truth = _blobs(n=200)
    before = k6.launches
    s = htt.cluster.Spectral(gamma=1.0, affinity="knn", n_neighbors=6, n_lanczos=60)
    s.fit(htt.array(x, split=0, comm=htt.MeshComm(4), device="cpu"))
    assert k6.launches == before
    assert s.n_clusters >= 1 and s.labels_.shape == (200, 1)
    with pytest.raises(NotImplementedError):
        htt.cluster.Spectral(affinity="cosine")
    with pytest.raises(RuntimeError):
        htt.cluster.Spectral(n_clusters=2).predict(htt.array(x, device="cpu"))


def test_spectral_from_state_predicts_as_jax(ht):
    x, truth = _blobs(seed=4)
    kw = dict(n_clusters=2, gamma=1.0, affinity="knn", n_neighbors=6, n_lanczos=60)
    a = ht.cluster.Spectral(**kw).fit(ht.array(x, split=0))
    b = htt.cluster.spectral_from_state(a.get_params(deep=False), a._cluster.cluster_centers_.numpy(), device="cpu")
    assert b.n_clusters == 2 and b.labels_ is None
    pa = a.predict(ht.array(x, split=0)).numpy()
    pb = b.predict(htt.array(x, split=0, device="cpu")).numpy()
    # equal up to the clusters' names: the embedding's signs differ between
    # the two eigensolvers, and the blobs then swap centres
    assert _same_partition(pb, pa) and _same_partition(pb, truth)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
def test_spectral_knn_on_card_matches_cpu(cuda, n):
    x, truth = _blobs()
    kw = dict(n_clusters=2, gamma=1.0, affinity="knn", n_neighbors=6, n_lanczos=60)
    before = k6.launches
    on_card = htt.cluster.Spectral(**kw).fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="gpu"))
    # one launch per position for each of the n_lanczos products
    assert k6.launches - before == 60 * n
    on_cpu = htt.cluster.Spectral(**kw).fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu"))
    assert _same_partition(on_card.labels_.numpy(), on_cpu.labels_.numpy())
    assert _same_partition(on_card.labels_.numpy(), truth)
