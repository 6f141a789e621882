"""QR and K4, the fused CholeskyQR panel pass: heat_tpu_torch against
heat_tpu on the CPU at meshes 1, 4 and 8, and the CUDA kernel against its
plain version on the card.

heat_tpu runs its classic lowerings here (autotune is off in the test
suite, and off the TPU the Pallas arms are off), so its ``qr`` is the same
algorithm as the port's on every route: TSQR for split 0 over several
positions, CholeskyQR2 for m >= 2n, blocked BCGS2 for n <= m < 2n, and
Householder when the Cholesky breaks down.  R has a positive diagonal, so Q
and R are unique and compared directly: to atol 1e-4 in float32 (the two
sum in different orders, and CholeskyQR squares the condition number), to
1e-10 in float64.  ``precision="mixed"`` rounds the first pass's operands
to bfloat16, where a rounding tie can fall either way, so the two agree to
atol 5e-3 there; a tall panel's Q must still be orthogonal to 1e-4.
"""

import importlib

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import qr_panel as k4

# the module (its package exports the function ``qr`` under the same name)
qr_mod = importlib.import_module("heat_tpu_torch.core.linalg.qr")


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


MESHES = (1, 4, 8)
F32 = dict(rtol=0.0, atol=1e-4)
F64 = dict(rtol=0.0, atol=1e-10)


def _rand(m, n, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(dtype)


def _qr_both(ht, x, n, split, **kw):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.linalg.qr(ht.array(x, split=split, comm=jc), **kw)
    b = htt.linalg.qr(htt.array(x, split=split, comm=tc, device="cpu"), **kw)
    return a, b


def _same(a, b, tol):
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), **tol)
    sa, sb = a.lshards(), b.lshards()
    assert [s.shape for s in sa] == [s.shape for s in sb]
    for x, y in zip(sa, sb):
        np.testing.assert_allclose(y, x, **tol)


def _check_factors(q, r, x, tol):
    q, r = q.numpy().astype(np.float64), r.numpy().astype(np.float64)
    np.testing.assert_allclose(q @ r, x, atol=tol * np.abs(x).max())
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=tol)
    np.testing.assert_array_equal(np.tril(r, -1), 0)
    assert (np.diag(r) > 0).all()


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_tall_skinny(ht, n, split):
    # split 0 over 4 or 8 positions: TSQR in both; otherwise CholeskyQR2
    x = _rand(512, 32, seed=1)
    a, b = _qr_both(ht, x, n, split)
    _same(a.Q, b.Q, F32)
    _same(a.R, b.R, F32)
    _check_factors(b.Q, b.R, x, 1e-4)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_square_blocked(ht, n, split):
    x = _rand(96, 96, seed=2)
    a, b = _qr_both(ht, x, n, split)
    _same(a.Q, b.Q, F32)
    _same(a.R, b.R, dict(rtol=0.0, atol=1e-4 * np.abs(a.R.numpy()).max()))
    _check_factors(b.Q, b.R, x, 1e-3)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape", [(512, 32), (96, 96), (40, 5)])
def test_r_only(ht, n, shape):
    x = _rand(*shape, seed=3)
    a, b = _qr_both(ht, x, n, 0, calc_q=False)
    assert a.Q is None and b.Q is None
    _same(a.R, b.R, dict(rtol=0.0, atol=1e-4 * np.abs(a.R.numpy()).max()))


@pytest.mark.parametrize("n", MESHES)
def test_defer_and_float64(ht, n):
    x = _rand(512, 32, seed=4)
    a, b = _qr_both(ht, x, n, None, check="defer")
    _same(a.Q, b.Q, F32)
    _same(a.R, b.R, F32)
    # 320 rows: heat_tpu's TSQR needs rows divisible by the positions
    x64 = _rand(320, 20, seed=5, dtype=np.float64)
    for split in (None, 0):
        a, b = _qr_both(ht, x64, n, split)
        _same(a.Q, b.Q, F64)
        _same(a.R, b.R, F64)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape", [(512, 32), (96, 96)])
def test_mixed_precision(ht, n, shape):
    x = _rand(*shape, seed=6)
    a, b = _qr_both(ht, x, n, None, precision="mixed")
    _same(a.Q, b.Q, dict(rtol=0.0, atol=5e-3))
    _same(a.R, b.R, dict(rtol=0.0, atol=5e-3 * np.abs(a.R.numpy()).max()))
    if shape[0] >= 2 * shape[1]:
        q = b.Q.numpy().astype(np.float64)
        np.testing.assert_allclose(q.T @ q, np.eye(shape[1]), atol=1e-4)


def _ill_conditioned():
    # tests/test_linalg.py:109-120: cond(A) = 1e7 overflows the f32 Gram
    rng = np.random.default_rng(143)
    u, _ = np.linalg.qr(rng.standard_normal((256, 8)))
    v, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    s = np.logspace(0, -7, 8)
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.parametrize("n", MESHES)
def test_ill_conditioned_falls_back_to_householder(ht, n, monkeypatch):
    import jax.numpy as jnp

    x = _ill_conditioned()
    # the CholeskyQR2 route breaks down (NaN-latched R) in both packages ...
    _, r_jax = importlib.import_module("heat_tpu.core.linalg.qr")._cholesky_qr2(jnp.asarray(x))
    _, r_port = qr_mod._cholesky_qr2(torch.from_numpy(x))
    assert not np.isfinite(np.asarray(r_jax)).all()
    assert not torch.isfinite(r_port).all()
    # ... so "eager" takes Householder: R's diagonal and the reconstruction
    # are the Householder factorisation's
    calls = []
    real = torch.linalg.qr
    monkeypatch.setattr(torch.linalg, "qr", lambda *a, **k: calls.append(1) or real(*a, **k))
    a, b = _qr_both(ht, x, n, None)
    assert calls == [1]
    for q, r in ((a.Q.numpy(), a.R.numpy()), (b.Q.numpy(), b.R.numpy())):
        np.testing.assert_allclose(q @ r, x, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-3)
        assert (np.diag(r) >= 0).all()
    np.testing.assert_allclose(b.R.numpy()[0], a.R.numpy()[0], rtol=1e-4, atol=1e-6)
    # "defer" returns the NaN-latched factors
    a, b = _qr_both(ht, x, n, None, check="defer")
    assert not np.isfinite(a.R.numpy()).all() and not np.isfinite(b.R.numpy()).all()


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_orthogonality_defect(ht, n, split):
    q = np.linalg.qr(_rand(40, 6, seed=7))[0].astype(np.float32) * np.float32(1.001)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.linalg.orthogonality_defect(ht.array(q, split=split, comm=jc))
    b = htt.linalg.orthogonality_defect(htt.array(q, split=split, comm=tc, device="cpu"))
    assert b.shape == () and b.split is None
    np.testing.assert_allclose(float(b), float(a), rtol=1e-3)


def _jax_panel(x):
    """heat_tpu's classic panel chain (qr.py:159-172, :183) on one panel."""
    import jax
    import jax.numpy as jnp

    xa = jnp.asarray(x)
    g = jax.lax.dot_general(xa, xa, (((0,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST)
    l = jnp.linalg.cholesky(g)
    eye = jnp.eye(x.shape[1], dtype=xa.dtype)
    rinv = jax.lax.linalg.triangular_solve(l, eye, lower=True, left_side=True).T
    return np.asarray(l.T), np.asarray(rinv)


@pytest.mark.parametrize("shape", [(300, 40), (64, 2), (400, 129)])
def test_plain_panel_against_jax_chain(ht, shape):
    x = _rand(*shape, seed=8)
    r_j, rinv_j = _jax_panel(x)
    r, rinv = k4.reference_fused_gram_chol(torch.from_numpy(x))
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0.0, atol=1e-4 * np.abs(r_j).max())
    np.testing.assert_allclose(rinv.numpy(), rinv_j, rtol=0.0, atol=1e-4 * np.abs(rinv_j).max())
    # the wrapper takes the plain version for a CPU tensor, without a launch
    before = k4.launches
    r2, _ = k4.fused_gram_chol(torch.from_numpy(x))
    assert k4.launches == before
    np.testing.assert_array_equal(r2.numpy(), r.numpy())


def test_plain_panel_nan_latch(ht):
    # a zero column makes the Gram singular: NaN in the same places in both
    # (R on and above its diagonal, R^-1 everywhere), zeros elsewhere
    x = _rand(100, 6, seed=9)
    x[:, 3] = 0
    r_j, rinv_j = _jax_panel(x)
    r, rinv = k4.reference_fused_gram_chol(torch.from_numpy(x))
    np.testing.assert_array_equal(r.numpy(), r_j)
    np.testing.assert_array_equal(rinv.numpy(), rinv_j)
    upper = np.triu_indices(6)
    assert np.isnan(r_j[upper]).all() and np.isnan(rinv_j).all()
    r64, _ = k4.reference_fused_gram_chol(torch.from_numpy(x.astype(np.float64)))
    assert torch.isnan(r64[upper]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        k4.fused_gram_chol(torch.zeros(3, 4, 5))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [(4096, 128), (100_003, 67), (2048, 1024), (64, 2), (3000, 200),
     (4096, 166), (4096, 191), (4096, 192), (20_000, 1000), (3000, 1025)],
)
def test_kernel_matches_plain_on_card(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda)
    before = k4.launches
    r, rinv = k4.fused_gram_chol(x)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    rr, rri = k4.reference_fused_gram_chol(x)
    assert float((r - rr).norm() / rr.norm()) <= 1e-5
    assert float((rinv - rri).norm() / rri.norm()) <= 1e-5
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))


@pytest.mark.gpu
def test_kernel_nan_latch_on_card(cuda):
    x = torch.randn(3000, 40, device=cuda)
    x[:, 7] = 0
    r, rinv = k4.fused_gram_chol(x)
    torch.cuda.synchronize()
    rr, rri = k4.reference_fused_gram_chol(x)
    assert torch.equal(torch.isnan(r), torch.isnan(rr)) and torch.isnan(rinv).all() and torch.isnan(rri).all()
    with pytest.raises(TypeError):
        k4.fused_gram_chol(x.double())


@pytest.mark.gpu
def test_kernel_reruns_bitwise_on_card(cuda):
    x = torch.randn(2048, 1024, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    r, rinv = k4.fused_gram_chol(x)
    r2, rinv2 = k4.fused_gram_chol(x)
    torch.cuda.synchronize()
    assert torch.equal(r, r2) and torch.equal(rinv, rinv2)


@pytest.mark.gpu
@pytest.mark.parametrize("col", [0, 700])
def test_kernel_nan_latch_on_the_wide_path(cuda, col):
    x = torch.randn(5000, 1000, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    x[:, col] = 0
    r, rinv = k4.fused_gram_chol(x)
    torch.cuda.synchronize()
    rr, rri = k4.reference_fused_gram_chol(x)
    assert torch.equal(torch.isnan(r), torch.isnan(rr)) and torch.equal(torch.isnan(rinv), torch.isnan(rri))
    assert torch.isnan(rinv).all() and torch.equal(torch.nan_to_num(r), torch.nan_to_num(rr))


@pytest.mark.gpu
def test_qr_launches_on_card(cuda):
    x = torch.randn(384, 256, device=cuda)
    before = k4.launches
    q, r = htt.linalg.qr(htt.array(x, split=0))
    torch.cuda.synchronize()
    # blocked BCGS2 (n <= m < 2n): two 384 x 128 CholeskyQR2 leaves, two
    # passes each
    assert k4.launches == before + 4
    qn, rn = q.larray.double(), r.larray.double()
    assert float((qn @ rn - x.double()).norm() / x.double().norm()) <= 1e-5
    q_cpu, r_cpu = htt.linalg.qr(htt.array(x.cpu(), split=0, device="cpu"))
    assert float((r.larray.cpu() - r_cpu.larray).abs().max()) <= 1e-3 * float(r_cpu.larray.abs().max())


# --- the blocked factorisation of K4's wide path (csrc/qr_panel.cu,
# chol_inv_blocked_kernel), emulated tile by tile in the kernel's order ---
B = 64


def _factor_diag(a, j0, bs):
    """factor_diag: symmetric elimination of [G | I] on the padded 64 x 64
    diagonal block; (L, L^-1) or None at a pivot that is not positive."""
    m = torch.eye(B)
    m[:bs, :bs] = a[j0 : j0 + bs, j0 : j0 + bs]
    e = torch.eye(B)
    idx = torch.arange(B)
    piv = torch.empty(B)
    for k in range(B):
        d = m[k, k]
        if not bool(d > 0):
            return None
        piv[k] = d
        # row i > k loses G[k][i] / G[k][k] times row k, in G's upper
        # triangle and in E
        mult = torch.where(idx > k, m[k] / d, torch.zeros(()))
        upper = (idx[:, None] > k) & (idx[None, :] >= idx[:, None])
        m = torch.where(upper, m - torch.outer(mult, m[k]), m)
        e = e - torch.outer(mult, e[k])
    s = torch.sqrt(piv)
    lt = torch.triu(m) / s[:, None]
    lt[idx, idx] = s
    return lt.T, torch.tril(e) / s[:, None]


def _blocked_chol_inv(g):
    """(r, rinv) from the Gram g as the wide path computes them: per block
    column j, phase 1 (diagonal factor, panel tiles, X's block row j), then
    phase 2 (trailing update, block forward substitution); NaN-latched.
    The kernel applies column j's update to column j + 1 inside phase 1 of
    j + 1 and the rest in the same interval: the same products, in the
    same order."""
    n = g.shape[0]
    nb = -(-n // B)
    a, y = g.clone(), torch.zeros(n, n)
    r = torch.zeros(n, n)
    t = lambda i: slice(i * B, min(n, (i + 1) * B))  # noqa: E731
    for j in range(nb):
        j0, bs = j * B, min(B, n - j * B)
        f = _factor_diag(a, j0, bs)
        if f is None:
            nan = torch.full((n, n), float("nan"))
            return torch.triu(nan), nan
        l, linv = f[0][:bs, :bs], f[1][:bs, :bs]
        r[t(j), t(j)] = l.T
        for i in range(nb):
            if i > j:
                a[t(i), t(j)] = a[t(i), t(j)] @ linv.T
            elif i < j:
                y[t(j), t(i)] = linv @ y[t(j), t(i)]
            else:
                y[t(j), t(j)] = linv
        for i in range(j + 1, nb):
            for k in range(j + 1, i + 1):
                a[t(i), t(k)] -= a[t(i), t(j)] @ a[t(k), t(j)].T
            for mm in range(j + 1):
                y[t(i), t(mm)] -= a[t(i), t(j)] @ y[t(j), t(mm)]
    blk = torch.arange(n) // B
    below = blk[:, None] > blk[None, :]  # the panel tiles; L_jj went to r
    r = r + torch.where(below, a, torch.zeros(())).T
    return r, torch.tril(y).T


@pytest.mark.parametrize("n", [166, 200, 1000])
def test_blocked_factorisation_against_jax_chain(ht, n):
    x = _rand(2 * n + 7, n, seed=10)
    r_j, rinv_j = _jax_panel(x)
    xt = torch.from_numpy(x)
    r, rinv = _blocked_chol_inv(xt.T @ xt)
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0.0, atol=1e-4 * np.abs(r_j).max())
    np.testing.assert_allclose(rinv.numpy(), rinv_j, rtol=0.0, atol=1e-4 * np.abs(rinv_j).max())
    assert torch.equal(torch.tril(r, -1), torch.zeros_like(r))


def test_blocked_factorisation_nan_latch_in_a_late_block():
    # a zero column in block 3 of 4: the plain version's NaN pattern
    x = _rand(600, 230, seed=11)
    x[:, 200] = 0
    xt = torch.from_numpy(x)
    r, rinv = _blocked_chol_inv(xt.T @ xt)
    rr, rri = k4.reference_fused_gram_chol(xt)
    assert torch.equal(torch.isnan(r), torch.isnan(rr)) and torch.equal(torch.isnan(rinv), torch.isnan(rri))
    assert torch.isnan(rinv).all() and torch.equal(torch.nan_to_num(r), torch.nan_to_num(rr))
