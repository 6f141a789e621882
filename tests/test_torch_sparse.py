"""The sparse tier: heat_tpu_torch's DCSR matrix, factories, elementwise ops,
``todense`` and ``sparse.matmul`` against heat_tpu on the CPU at port meshes
of 1, 4 and 8 positions.

Exact agreement is required of shapes, splits, per-position CSR triples and
of sums and products of two entries (one rounding each, in both).  The
sparse product sums in other orders: |Δy| ≤ 1e-6·Σⱼ|A·x| per row for f32
(bitwise on integer-valued data), 1e-12 for f64.  heat_tpu runs with its
autotune off (the conftest default), so its ``sparse.matmul`` is the
``gather`` arm.
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


def _csr(n=13, m=11, density=0.3, seed=0, zero_rows=(), integer=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(n, m, density=density, random_state=rng, format="csr", dtype=np.float64)
    if integer:
        sp.data = np.abs(sp.data * 900).astype(np.int64) % 7 + 1.0
    lil = sp.tolil()
    for r in zero_rows:
        lil.rows[r] = []
        lil.data[r] = []
    return lil.tocsr().astype(dtype)


def _pair(ht, sp, n, split=0, **kw):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.sparse.sparse_csr_matrix(sp, split=split, comm=jc, **kw)
    b = htt.sparse.sparse_csr_matrix(sp, split=split, comm=tc, device="cpu", **kw)
    return a, b, jc, tc


def _same_triples(a, b):
    assert b.nshards == a.nshards
    for r in range(a.nshards):
        for x, y in zip(a.shard_csr(r), b.shard_csr(r)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [0, None])
def test_factory_triples_equal_jax(ht, n, split):
    sp = _csr(zero_rows=(12,))
    a, b, _, _ = _pair(ht, sp, n, split=split)
    assert b.shape == a.shape and b.split == a.split and b.nnz == a.nnz
    assert b.lnnz_all == a.lnnz_all and b.rows_per_shard == a.rows_per_shard
    assert b.dtype is htt.float32 and b.is_distributed() == a.is_distributed()
    assert b.counts_displs_nnz() == a.counts_displs_nnz()
    _same_triples(a, b)
    assert (b.to_scipy() != sp).nnz == 0


def test_factory_inputs_and_capacity_options():
    sp = _csr(seed=1)
    dense = sp.toarray()
    comm = htt.MeshComm(4)
    ref = htt.sparse.sparse_csr_matrix(sp, split=0, comm=comm, device="cpu")
    for obj in (dense, torch.from_numpy(dense), htt.array(dense, device="cpu"), ref):
        b = htt.sparse.sparse_csr_matrix(obj, split=0, comm=comm, device="cpu")
        assert (b.to_scipy() != sp).nnz == 0
    capped = htt.sparse.sparse_csr_matrix(sp, split=0, comm=comm, device="cpu", min_row_cap=5, pow2_cap=True)
    for x, y in zip(capped._shards, ref._shards):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    with pytest.raises(ValueError):
        htt.sparse.sparse_csr_matrix(sp, split=1, device="cpu")
    # the constructor takes a scipy matrix too, as the JAX package's does
    direct = htt.sparse.DCSR_matrix(sp, sp.nnz, sp.shape, htt.float32, 0, ref.device, comm)
    _same_triples(ref, direct)
    with pytest.raises(ValueError):
        htt.sparse.DCSR_matrix(sp, sp.nnz + 1, sp.shape, htt.float32, 0, ref.device, comm)
    with pytest.raises(TypeError):
        htt.sparse.DCSR_matrix(sp.toarray(), sp.nnz, sp.shape, htt.float32, 0, ref.device, comm)
    # duplicates are summed, the caller's matrix untouched
    dup = scipy.sparse.csr_matrix((np.ones(3, np.float32), np.array([1, 1, 0]), np.array([0, 2, 3])), shape=(2, 2))
    b = htt.sparse.sparse_csr_matrix(dup, device="cpu")
    assert b.nnz == 2 and dup.nnz == 3


@pytest.mark.parametrize("n", MESHES)
def test_todense_equals_jax(ht, n):
    sp = _csr(zero_rows=(3,))
    a, b, jc, tc = _pair(ht, sp, n)
    da, db = a.todense(), b.todense()
    assert db.shape == da.shape and db.split == da.split and db.dtype is htt.float32
    np.testing.assert_array_equal(db.numpy(), da.numpy())
    assert [s.shape for s in db.lshards()] == [s.shape for s in da.lshards()]
    out = htt.zeros(sp.shape, dtype=htt.float64, comm=tc, device="cpu")
    assert htt.sparse.to_dense(b, out=out) is out
    assert out.dtype is htt.float64 and out.split == 0
    np.testing.assert_array_equal(out.numpy(), sp.toarray())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("op", ["add", "mul"])
def test_elementwise_ops_equal_jax(ht, n, op):
    s1, s2 = _csr(seed=2), _csr(seed=3)
    s2[0, 0] = -s1[0, 0] if s1[0, 0] else 1.0  # a sum that cancels to an explicit zero
    s2 = s2.tocsr()
    a1, b1, jc, tc = _pair(ht, s1, n)
    a2 = ht.sparse.sparse_csr_matrix(s2, split=0, comm=jc)
    b2 = htt.sparse.sparse_csr_matrix(s2, split=0, comm=tc, device="cpu")
    a = getattr(ht.sparse, op)(a1, a2)
    b = getattr(htt.sparse, op)(b1, b2)
    assert b.shape == a.shape and b.split == a.split and b.nnz == a.nnz and b.dtype is htt.float32
    _same_triples(a, b)
    c = b1 + b2 if op == "add" else b1 * b2
    _same_triples(b, c)


def test_elementwise_ops_promote_and_align_splits(ht):
    s1, s2 = _csr(seed=4), _csr(seed=5, dtype=np.float64)
    a1, b1, jc, tc = _pair(ht, s1, 4)
    a2 = ht.sparse.sparse_csr_matrix(s2, comm=jc)
    b2 = htt.sparse.sparse_csr_matrix(s2, comm=tc, device="cpu")
    a, b = ht.sparse.add(a2, a1), htt.sparse.add(b2, b1)
    assert b.dtype is htt.float64 and b.split == a.split == 0
    _same_triples(a, b)
    with pytest.raises(ValueError):
        htt.sparse.mul(b1, htt.sparse.sparse_csr_matrix(_csr(n=5), device="cpu"))


@pytest.mark.parametrize("n", MESHES)
def test_astype_and_resplit(ht, n):
    sp = _csr(seed=6)
    a, b, _, _ = _pair(ht, sp, n)
    _same_triples(a.astype(ht.float64), b.astype(htt.float64))
    for split in (None, 0):
        _same_triples(a.resplit(split), b.resplit(split))
    b64 = b.astype(htt.float64, copy=True)
    assert b64.dtype is htt.float64 and b.dtype is htt.float32
    b.astype(htt.float64, copy=False)
    assert b.dtype is htt.float64 and b.shard_csr(0)[0].dtype == np.float64


def _check_product(got, want, sp, x):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        return
    x2 = x[:, None] if x.ndim == 1 else x
    scale = (abs(sp).astype(np.float64) @ np.abs(x2.astype(np.float64))).reshape(got.shape)
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("split", [0, None])
def test_matmul_equals_jax(ht, n, k, split):
    sp = _csr(n=37, m=29, density=0.2, seed=7, zero_rows=tuple(range(33, 37)))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(29,) if k is None else (29, k)).astype(np.float32)
    a, b, jc, tc = _pair(ht, sp, n, split=split)
    want = ht.sparse.matmul(a, ht.array(x, comm=jc))
    before = k6.launches
    got = htt.sparse.matmul(b, htt.array(x, comm=tc, device="cpu"))
    assert k6.launches == before  # the CPU takes the plain version
    assert got.shape == want.shape and got.split == want.split and got.dtype is htt.float32
    assert [s.shape for s in got.lshards()] == [s.shape for s in want.lshards()]
    _check_product(got.numpy(), want.numpy(), sp, x)
    _check_product((b @ x).numpy(), want.numpy(), sp, x)
    # the kernel's repacking is built once and cached on the matrix
    assert b._spmv_panels is not None and len(b._spmv_panels) == b.nshards


@pytest.mark.parametrize("n", MESHES)
def test_matmul_integer_data_is_bitwise(ht, n):
    sp = _csr(n=40, m=64, density=0.15, seed=9, integer=True)
    x = np.random.default_rng(10).integers(-4, 5, size=(64, 3)).astype(np.float32)
    a, b, jc, tc = _pair(ht, sp, n)
    np.testing.assert_array_equal(
        htt.sparse.matmul(b, x).numpy(), ht.sparse.matmul(a, ht.array(x, comm=jc)).numpy()
    )


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtypes", [(np.float32, np.float64), (np.float64, np.float32), (np.float64, np.float64), (np.float32, np.int32)])
def test_matmul_promotion_and_the_gather_path(ht, n, dtypes):
    sp = _csr(n=21, m=17, seed=11, dtype=dtypes[0])
    x = (np.random.default_rng(12).normal(size=(17, 2)) * 4).astype(dtypes[1])
    a, b, jc, tc = _pair(ht, sp, n)
    want = ht.sparse.matmul(a, ht.array(x, comm=jc))
    got = htt.sparse.matmul(b, htt.array(x, comm=tc, device="cpu"))
    _check_product(got.numpy(), want.numpy(), sp, x.astype(np.float64))


def test_matmul_out_and_errors(ht):
    sp = _csr(seed=13)
    x = np.random.default_rng(14).normal(size=(11, 2)).astype(np.float32)
    a, b, jc, tc = _pair(ht, sp, 4)
    out = htt.zeros((13, 2), dtype=htt.float64, comm=tc, device="cpu")
    res = htt.sparse.matmul(b, x, out=out)
    assert res is out and out.dtype is htt.float64 and out.split == 0
    np.testing.assert_allclose(out.numpy(), sp @ x.astype(np.float64), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        htt.sparse.matmul(b, x, out=htt.zeros((13, 3), comm=tc, device="cpu"))
    with pytest.raises(ValueError):
        htt.sparse.matmul(b, np.ones(12, np.float32))
    with pytest.raises(TypeError):
        htt.sparse.matmul(sp, x)


def test_matvec_program_never_densifies():
    sp = _csr(n=30, m=30, seed=15)
    comm = htt.MeshComm(4)
    v = torch.from_numpy(np.random.default_rng(16).normal(size=30).astype(np.float32))
    b = htt.sparse.sparse_csr_matrix(sp, split=0, comm=comm, device="cpu")
    apply_fn, ops = htt.sparse.matvec_program(b)
    assert len(ops) == 4 and all(isinstance(t, k6.Panels) and t.ncols == 30 for t in ops)
    np.testing.assert_allclose(apply_fn(ops, v).numpy(), sp @ v.numpy(), rtol=1e-5, atol=1e-6)
    b64 = b.astype(htt.float64)
    apply_fn, ops = htt.sparse.matvec_program(b64)
    np.testing.assert_allclose(apply_fn(ops, v.double()).numpy(), sp.astype(np.float64) @ v.double().numpy(), rtol=1e-12)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", MESHES)
def test_matmul_on_card_launches_k6_per_position(cuda, n):
    sp = _csr(n=37, m=29, density=0.2, seed=17, zero_rows=tuple(range(33, 37)))
    x = np.random.default_rng(18).normal(size=(29, 4)).astype(np.float32)
    b = htt.sparse.sparse_csr_matrix(sp, split=0, comm=htt.MeshComm(n), device="gpu")
    before = k6.launches
    got = htt.sparse.matmul(b, htt.array(x, comm=htt.MeshComm(n), device="gpu"))
    # a position of zero rows (37 rows over 8) launches nothing
    assert k6.launches == before + sum(1 for d, _, p in b._shards if p.numel() > 1)
    _check_product(got.numpy(), sp @ x, sp, x)
    b64 = b.astype(htt.float64)
    before = k6.launches
    _check_product(htt.sparse.matmul(b64, x.astype(np.float64)).numpy(), sp.astype(np.float64) @ x.astype(np.float64), sp, x)
    assert k6.launches == before
