"""bf16/f16 KMeans: heat_tpu_torch against heat_tpu on the CPU, on dense
16-bit arrays and on packed samples, and the port on the card.

The inputs are well-separated blobs made in f32 from a seed and rounded to
the 16-bit type, started from explicit 16-bit centres.  Both packages then
run the same Lloyd iterations: labels from f32 distances, counts and sums in
f32, each update rounded to the data's type.  So ``labels_``, ``predict``
and ``n_iter_`` must be equal.  The f32 sums are taken in different orders,
so a centre may round to the neighbouring 16-bit value: centres agree to
one 16-bit ulp.  ``inertia_`` is a sum of ~10^2 f32 distances in another
order, over centres within that ulp (a second-order change at a centroid):
rtol 1e-4.  heat_tpu takes bf16 data with f | 128 through its lane-packed
loop and f = 20 and f16 through its plain loop; the port has one loop for
all, and both inertia definitions: the dense path's (last iteration, before
its update) and the packed path's (a labels pass against the final centres).
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import cdist as k1

MESHES = (1, 4, 8)
# (f, 16-bit type): packable bf16 widths, a bf16 width that does not pack,
# and f16 (never packed)
WIDTHS = [(4, "bfloat16"), (16, "bfloat16"), (64, "bfloat16"), (20, "bfloat16"), (16, "float16")]
# heat_tpu's dense fit of bf16 at f = 4 packs 32 samples a row inside the
# fit, a program that compiles for many minutes on an 8-position CPU mesh:
# the dense f = 4 fit is compared at 1 and 4 positions (the packed one at 8)
SLOW_IN_JAX = {(4, 8)}


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _np_type(name):
    # the card tests build their data in torch: only the parity tests need
    # ml_dtypes for bf16
    return pytest.importorskip("ml_dtypes").bfloat16 if name == "bfloat16" else np.float16


def _blobs32(f, per, seed, k):
    """Blobs in f32 and, as the start, the first sample drawn for each."""
    rng = np.random.default_rng(seed + f)
    centres = 4.0 * rng.normal(size=(k, f))
    x = np.concatenate([rng.normal(c, 0.5, size=(per, f)) for c in centres])
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), np.argsort(perm)[np.arange(k) * per]


def _blobs16(f, name, per=40, seed=0, k=3):
    x, first = _blobs32(f, per, seed, k)
    x = x.astype(_np_type(name))
    return x, x[first]


def _blobs_torch(f, name, per=40, seed=0, k=3):
    x, first = _blobs32(f, per, seed, k)
    x = torch.from_numpy(x).to(getattr(torch, name))
    return x, x[first]


def _within_one_ulp(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mant = 7 if name == "bfloat16" else 10
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-14)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - mant)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def _meshes(f):
    return [n for n in MESHES if (f, n) not in SLOW_IN_JAX]


def _cases():
    return [(f, name, n) for f, name in WIDTHS for n in _meshes(f)]


def _fit_pair(ht, x, c0, n, split, packed, **kw):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    xa = ht.array(x, split=split, comm=jc)
    xb = htt.array(x, split=split, comm=tc, device="cpu")
    if packed:
        xa, xb = ht.cluster.pack(xa), htt.cluster.pack(xb)
    a = ht.cluster.KMeans(n_clusters=len(c0), init=ht.array(c0, comm=jc), **kw).fit(xa)
    b = htt.cluster.KMeans(n_clusters=len(c0), init=htt.array(c0, comm=tc, device="cpu"), **kw).fit(xb)
    return a, b, xa, xb


@pytest.mark.parametrize("f, name, n", _cases())
@pytest.mark.parametrize("split", [0, None])
def test_dense_fit_matches_jax(ht, f, name, n, split):
    x, c0 = _blobs16(f, name)
    a, b, _, _ = _fit_pair(ht, x, c0, n, split, False, max_iter=30, tol=1e-4)
    assert b.n_iter_ == a.n_iter_
    assert b.cluster_centers_.dtype.__name__ == a.cluster_centers_.dtype.__name__ == name
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    assert b.labels_.shape == a.labels_.shape and b.labels_.split == a.labels_.split
    _within_one_ulp(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), name)
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-4)


@pytest.mark.parametrize("f, name, n", _cases())
def test_dense_predict_and_max_iter_match_jax(ht, f, name, n):
    x, c0 = _blobs16(f, name, seed=1)
    a, b, _, _ = _fit_pair(ht, x, c0, n, 0, False, max_iter=2, tol=-1.0)
    assert a.n_iter_ == b.n_iter_ == 2
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-4)
    new, _ = _blobs16(f, name, per=9, seed=2)
    pa = a.predict(ht.array(new, split=0, comm=ht.parallel.mesh.local_mesh(n)))
    pb = b.predict(htt.array(new, split=0, comm=htt.MeshComm(n), device="cpu"))
    np.testing.assert_array_equal(pb.numpy(), pa.numpy())
    assert [s.shape for s in pb.lshards()] == [s.shape for s in pa.lshards()]


PACKED = [(f, n) for f, name in WIDTHS if name == "bfloat16" and 128 % f == 0 for n in MESHES]


@pytest.mark.parametrize("f, n", PACKED)
@pytest.mark.parametrize("per", [40, 41])
def test_packed_fit_and_predict_match_jax(ht, f, n, per):
    # per = 41: 123 samples leave a zero tail in the last packed row
    x, c0 = _blobs16(f, "bfloat16", per=per, seed=3)
    a, b, xa, xb = _fit_pair(ht, x, c0, n, 0, True, max_iter=30, tol=1e-4)
    assert (xb.n, xb.f, xb.p, xb.shape) == (xa.n, xa.f, xa.p, xa.shape)
    assert b.n_iter_ == a.n_iter_
    assert b.labels_.shape == a.labels_.shape == (len(x),)
    assert b.labels_.dtype is htt.int32 and b.labels_.split == a.labels_.split
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    assert [s.shape for s in b.labels_.lshards()] == [s.shape for s in a.labels_.lshards()]
    _within_one_ulp(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), "bfloat16")
    # the packed inertia_: a labels pass against the final centres
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-4)
    np.testing.assert_array_equal(b.predict(xb).numpy(), a.predict(xa).numpy())


@pytest.mark.parametrize("n", MESHES)
def test_packed_samples_built_from_a_payload_match_jax(ht, n):
    # PackedSamples over the same (ceil(n/p), p*f) numpy payload in both
    # packages, its zero tail made by hand
    x, c0 = _blobs16(32, "bfloat16", per=41, seed=9)
    p = 128 // 32
    payload = np.zeros((-(-len(x) // p) * p, 32), x.dtype)
    payload[: len(x)] = x
    payload = payload.reshape(-1, p * 32)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    xa = ht.cluster.PackedSamples(ht.array(payload, split=0, comm=jc), len(x), 32)
    xb = htt.cluster.PackedSamples(htt.array(payload, split=0, comm=tc, device="cpu"), len(x), 32)
    a = ht.cluster.KMeans(n_clusters=3, init=ht.array(c0, comm=jc), max_iter=30).fit(xa)
    b = htt.cluster.KMeans(n_clusters=3, init=htt.array(c0, comm=tc, device="cpu"), max_iter=30).fit(xb)
    assert b.n_iter_ == a.n_iter_
    np.testing.assert_array_equal(b.labels_.numpy(), a.labels_.numpy())
    _within_one_ulp(b.cluster_centers_.numpy(), a.cluster_centers_.numpy(), "bfloat16")
    np.testing.assert_allclose(b.inertia_, a.inertia_, rtol=1e-4)


@pytest.mark.parametrize("n", MESHES)
def test_packed_and_dense_inertia_definitions(ht, n):
    # after one iteration the dense path reports the distances to the
    # starting centres, the packed path those to the updated ones
    x, c0 = _blobs16(64, "bfloat16", seed=4)
    a_d, b_d, _, _ = _fit_pair(ht, x, c0, n, 0, False, max_iter=1, tol=-1.0)
    a_p, b_p, _, _ = _fit_pair(ht, x, c0, n, 0, True, max_iter=1, tol=-1.0)
    np.testing.assert_allclose(b_d.inertia_, a_d.inertia_, rtol=1e-4)
    np.testing.assert_allclose(b_p.inertia_, a_p.inertia_, rtol=1e-4)
    start = ((x.astype(np.float64)[:, None] - c0.astype(np.float64)[None]) ** 2).sum(-1).min(1).sum()
    np.testing.assert_allclose(b_d.inertia_, start, rtol=1e-4)
    assert b_p.inertia_ < b_d.inertia_


@pytest.mark.parametrize("init", ["random", "kmeans++"])
@pytest.mark.parametrize("n", MESHES)
def test_packed_seeded_init_runs_and_is_mesh_invariant(init, n):
    x, _ = _blobs16(16, "bfloat16", per=50, seed=5)
    fits = []
    for m in (1, n):
        xb = htt.cluster.pack(htt.array(x, split=0, comm=htt.MeshComm(m), device="cpu"))
        fits.append(htt.cluster.KMeans(n_clusters=3, init=init, max_iter=20, random_state=7).fit(xb))
    np.testing.assert_array_equal(fits[1].labels_.numpy(), fits[0].labels_.numpy())
    np.testing.assert_array_equal(fits[1].cluster_centers_.numpy().view(np.int16),
                                  fits[0].cluster_centers_.numpy().view(np.int16))
    assert fits[0].cluster_centers_.dtype is htt.bfloat16


def test_packed_random_init_is_the_dense_draw():
    # the stratified draw picks the same samples from packed and dense data
    x, _ = _blobs16(32, "bfloat16", per=30, seed=6)
    tc = htt.MeshComm(4)
    dense = htt.cluster.KMeans(n_clusters=3, init="random", max_iter=1, tol=-1.0, random_state=3)
    dense._initialize_cluster_centers(htt.array(x, split=0, comm=tc, device="cpu"))
    packed = htt.cluster.pack(htt.array(x, split=0, comm=tc, device="cpu"))
    km = htt.cluster.KMeans(n_clusters=3, init="random", random_state=3)
    got = km._init_centers_packed(packed, packed.sample_blocks())
    assert torch.equal(got, dense.cluster_centers_.larray)


def test_packed_fit_makes_no_f32_copy(monkeypatch):
    seen = []
    real = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda a, b, sqrt=True: seen.append((a.dtype, b.dtype, a.shape[0])) or real(a, b, sqrt))
    x, c0 = _blobs16(64, "bfloat16", per=41, seed=7)
    xb = htt.cluster.pack(htt.array(x, split=0, comm=htt.MeshComm(4), device="cpu"))
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(c0, device="cpu"), max_iter=3, tol=-1.0).fit(xb)
    # 3 Lloyd steps + the labels pass, per position; the zero tail's slot
    # is never read
    assert [s[:2] for s in seen] == [(torch.bfloat16, torch.bfloat16)] * 16
    assert sum(s[2] for s in seen) == 4 * len(x)
    assert km.labels_.shape == (len(x),)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_dense_fit_on_card_goes_through_k1(cuda, name):
    x, _ = _blobs_torch(64, name, per=300, seed=8)
    k, iters, n = 3, 5, 4
    k1.launches = 0
    km = htt.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=iters, tol=-1.0, random_state=0)
    km.fit(htt.array(x, split=0, comm=htt.MeshComm(n), device="gpu"))
    assert k1.launches == n * (k + iters + 1)
    assert km.cluster_centers_.dtype is getattr(htt, name)
    # a step on the CPU from the fitted centres gives the same labels and
    # centres (the fit has converged)
    start = htt.array(km.cluster_centers_.larray.cpu(), device="cpu")
    ref = htt.cluster.KMeans(n_clusters=k, init=start, max_iter=1, tol=-1.0)
    ref.fit(htt.array(x, split=0, device="cpu"))
    np.testing.assert_array_equal(km.labels_.numpy(), ref.labels_.numpy())
    _within_one_ulp(ref.cluster_centers_.larray.float().numpy(), km.cluster_centers_.larray.float().cpu().numpy(), name)


@pytest.mark.gpu
def test_packed_fit_on_card_goes_through_k1(cuda):
    htt.random.seed(1)
    xb = htt.cluster.randn_packed(100_001, 64, device="gpu")
    k1.launches = 0
    km = htt.cluster.KMeans(n_clusters=8, init="random", max_iter=3, tol=-1.0, random_state=0).fit(xb)
    assert k1.launches == 3 + 1
    assert km.labels_.shape == (100_001,) and km.labels_.dtype is htt.int32
    # the labels pass on the CPU against the same centres, wherever the
    # nearest two centres are further apart than K1's tolerance (normal
    # samples have near-ties)
    ref = htt.cluster.KMeans(n_clusters=8)
    ref._cluster_centers = htt.array(km.cluster_centers_.larray.cpu(), device="cpu")
    cpu = htt.cluster.PackedSamples(htt.array(xb.x2.larray.cpu(), split=0, device="cpu"), xb.n, xb.f)
    x = cpu.sample_blocks()[0].float()
    c = ref._cluster_centers.larray.float()
    top2 = k1.reference_cdist(x, c, sqrt=False).topk(2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0] > 2e-5 * ((x * x).sum(1) + (c * c).sum(1).max())).numpy()
    assert clear.mean() > 0.99
    want = ref._predict_packed(cpu).numpy()
    np.testing.assert_array_equal(want[clear], km.labels_.numpy()[clear])


@pytest.mark.gpu
def test_onehot_sums_on_card_are_f32_without_a_copy(cuda):
    from heat_tpu_torch.cluster import kmeans

    g = torch.Generator(device=cuda).manual_seed(0)
    xs = torch.randn(1_000_003, 64, generator=g, device=cuda).to(torch.bfloat16)
    onehot = (torch.randint(0, 8, (1_000_003,), generator=g, device=cuda)[:, None]
              == torch.arange(8, device=cuda)[None, :]).to(torch.bfloat16)
    kmeans._onehot_sums(onehot, xs)  # cuBLAS's workspace is allocated once, here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = kmeans._onehot_sums(onehot, xs)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.cuda.max_memory_allocated() - base < xs.numel() * 4
    want = onehot.T.double() @ xs.double()
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
