"""K6, the ELL sparse matrix-vector kernel: heat_tpu_torch's packer and plain
version against heat_tpu on the CPU, and the CUDA kernel against its plain
version on the card.

Tolerance: the two sum a row's products in different orders, so
|Δy| ≤ 1e-6·Σⱼ|vals·x| per row on real-valued data (1e-5 on the card, where
the kernel's butterfly order differs more); on integer-valued data every
partial sum is exact and the results are bitwise equal.  heat_tpu's static
``sparse.matmul`` (its autotune off, the conftest default) is the ``gather``
arm; its kernel runs in interpret mode.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from heat_tpu_torch.ops import spmv as k6


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _csr(n, m, density=0.15, seed=0, zero_rows=(), integer=False, long_row=None):
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(n, m, density=density, random_state=rng, format="csr", dtype=np.float32)
    if integer:
        sp.data = (np.abs(sp.data * 900).astype(np.int64) % 7 + 1).astype(np.float32)
    lil = sp.tolil()
    for r in zero_rows:
        lil.rows[r] = []
        lil.data[r] = []
    if long_row is not None:
        lil.rows[long_row] = list(range(m))
        row = rng.integers(1, 8, size=m) if integer else rng.normal(size=m)
        lil.data[long_row] = list(row.astype(np.float32))
    sp = lil.tocsr()
    sp.sort_indices()
    return sp


def _x(m, k=None, seed=1, integer=False):
    rng = np.random.default_rng(seed)
    shape = (m,) if k is None else (m, k)
    if integer:
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _pack(sp):
    width = k6.ell_width(int(np.diff(sp.indptr).max()) if sp.shape[0] else 0)
    return k6.ell_pack(torch.from_numpy(sp.data), torch.from_numpy(sp.indices), torch.from_numpy(sp.indptr), width)


def _scale(sp, x):
    """Σⱼ|vals·x| per row (and column of x)."""
    a = abs(sp).astype(np.float64)
    return a @ np.abs(x.astype(np.float64))


CASES = [
    dict(n=40, m=64, seed=3),
    dict(n=37, m=52, seed=5, zero_rows=tuple(range(33, 37))),
    dict(n=64, m=300, seed=6, zero_rows=(0, 1, 31), long_row=17),
    dict(n=1, m=5, seed=7, density=1.0),
]


@pytest.mark.parametrize("n,w", [(0, 32), (1, 32), (32, 32), (33, 64), (129, 160)])
def test_width_rounds_to_a_warp(n, w):
    assert k6.ell_width(n) == w


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
def test_pack_live_slots_equal_jax(ht, case):
    sp = _csr(**case)
    vals, cols = _pack(sp)
    assert vals.dtype == torch.float32 and cols.dtype == torch.int32
    assert tuple(vals.shape) == (sp.shape[0], k6.ell_width(int(np.diff(sp.indptr).max())))
    jw = ht.ops.spmv.ell_width(int(np.diff(sp.indptr).max()))
    jv, jc = ht.ops.spmv.ell_pack(sp.data, sp.indices, sp.indptr, jw)
    counts = np.diff(sp.indptr)
    v, c = vals.numpy(), cols.numpy()
    for r, cnt in enumerate(counts):
        np.testing.assert_array_equal(v[r, :cnt], jv[r, :cnt])
        np.testing.assert_array_equal(c[r, :cnt], jc[r, :cnt])
        assert np.all(c[r, cnt:] == -1) and np.all(v[r, cnt:] == 0)


def test_pack_rejects_a_row_wider_than_the_slab():
    sp = _csr(8, 40, density=1.0, seed=2)
    with pytest.raises(ValueError):
        k6.ell_pack(torch.from_numpy(sp.data), torch.from_numpy(sp.indices), torch.from_numpy(sp.indptr), 32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
@pytest.mark.parametrize("k", [None, 1, 4])
def test_reference_against_jax_interpret(ht, case, k):
    sp = _csr(**case)
    x = _x(sp.shape[1], k, seed=case["seed"] + 10)
    jw = ht.ops.spmv.ell_width(int(np.diff(sp.indptr).max()))
    jv, jc = ht.ops.spmv.ell_pack(sp.data, sp.indices, sp.indptr, jw)
    x2 = x[:, None] if x.ndim == 1 else x
    want = np.stack([np.asarray(ht.ops.spmv.spmv_ell(jv, jc, x2[:, j], interpret=True))[: sp.shape[0]]
                     for j in range(x2.shape[1])], axis=1)
    vals, cols = _pack(sp)
    got = k6.reference_spmv_ell(vals, cols, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape[:0] + (sp.shape[0],) + x.shape[1:]
    got2 = got[:, None] if got.ndim == 1 else got
    assert np.all(np.abs(got2 - want) <= 1e-6 * _scale(sp, x2) + 1e-30)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("integer", [False, True])
def test_reference_against_jax_gather_arm(ht, case, k, integer):
    sp = _csr(**case, integer=integer)
    x = _x(sp.shape[1], k, seed=case["seed"] + 20, integer=integer)
    want = ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy()
    vals, cols = _pack(sp)
    got = k6.reference_spmv_ell(vals, cols, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        scale = _scale(sp, x[:, None] if x.ndim == 1 else x).reshape(got.shape)
        assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


def test_wrapper_on_cpu_is_the_plain_version():
    sp = _csr(30, 45, seed=8)
    vals, cols = _pack(sp)
    x = torch.from_numpy(_x(45, 4, seed=9))
    before = k6.launches
    torch.testing.assert_close(k6.spmv_ell(vals, cols, x), k6.reference_spmv_ell(vals, cols, x), rtol=0, atol=0)
    assert k6.launches == before


def test_zero_row_block():
    vals = torch.zeros((0, 32))
    cols = torch.full((0, 32), -1, dtype=torch.int32)
    y = k6.spmv_ell(vals, cols, torch.ones(7, 3))
    assert tuple(y.shape) == (0, 3) and y.dtype == torch.float32


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        k6.spmv_ell(torch.zeros(4, 32), torch.zeros(4, 64, dtype=torch.int32), torch.zeros(5))
    with pytest.raises(ValueError):
        k6.spmv_ell(torch.zeros(4, 32), torch.zeros(4, 32, dtype=torch.int32), torch.zeros(5, 2, 2))


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + [dict(n=5000, m=3000, seed=11, density=0.01, zero_rows=(0, 4999))],
                         ids=lambda c: f"{c['n']}x{c['m']}")
@pytest.mark.parametrize("k", [None, 1, 4, 5])
@pytest.mark.parametrize("integer", [False, True])
def test_kernel_against_plain_on_card(cuda, case, k, integer):
    sp = _csr(**case, integer=integer)
    x = _x(sp.shape[1], k, seed=case["seed"] + 30, integer=integer)
    vals, cols = (t.to(cuda) for t in _pack(sp))
    xt = torch.from_numpy(x).to(cuda)
    before = k6.launches
    got = k6.spmv_ell(vals, cols, xt)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and tuple(got.shape) == (sp.shape[0],) + x.shape[1:]
    want = k6.reference_spmv_ell(vals, cols, xt)
    if integer:
        assert torch.equal(got, want)
    else:
        scale = _scale(sp, x[:, None] if x.ndim == 1 else x).reshape(got.shape)
        assert np.all(np.abs(got.cpu().numpy() - want.cpu().numpy()) <= 1e-5 * scale + 1e-30)
    # a fixed summation order: a second launch is bitwise equal
    assert torch.equal(k6.spmv_ell(vals, cols, xt), got)


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    vals = torch.zeros(4, 32, device=cuda)
    cols = torch.zeros(4, 32, dtype=torch.int32, device=cuda)
    x = torch.zeros(6, device=cuda)
    with pytest.raises(TypeError):
        k6.spmv_ell(vals.double(), cols, x.double())
    with pytest.raises(TypeError):
        k6.spmv_ell(vals, cols.long(), x)
    with pytest.raises(ValueError):
        k6.spmv_ell(torch.zeros(4, 48, device=cuda), torch.zeros(4, 48, dtype=torch.int32, device=cuda), x)
    with pytest.raises(ValueError):
        k6.spmv_ell(vals, cols, x.cpu())
