"""Lasso and K5, the coordinate-descent sweep: heat_tpu_torch against
heat_tpu on the CPU at meshes 1, 4 and 8, and the CUDA kernel against its
plain version on the card.

heat_tpu runs its classic sweep here (``_cd_sweep``; autotune is off in the
test suite and the Pallas arm is off the TPU), which is the same update
order as the port's.  The two sum each coordinate's dot product in
different orders, so float32 coefficients agree to atol 1e-5 after a few
sweeps (float64 to 1e-12).  With the default tolerance both stop after the
same number of sweeps on these inputs, whose last change lies far from
``tol``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import lasso_sweep as k5


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
F32 = dict(rtol=0.0, atol=1e-5)


def _data(m=400, n=16, seed=0, dtype=np.float32):
    """The benchmark's recipe (benchmarks/cb/regression.py:17-24) at a small
    size: unit-RMS features, a sparse beta, a little noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n))
    x /= np.sqrt((x * x).mean(0))
    beta = np.zeros(n)
    beta[:: max(n // 4, 1)] = 2.0
    y = x @ beta + 0.5 + 0.01 * rng.normal(size=m)
    return x.astype(dtype), y.reshape(-1, 1).astype(dtype)


def _fit_both(ht, n, x, y, split=0, **kw):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    jx, jy = ht.array(x, split=split, comm=jc), ht.array(y, split=split, comm=jc)
    tx, ty = htt.array(x, split=split, comm=tc, device="cpu"), htt.array(y, split=split, comm=tc, device="cpu")
    a = ht.regression.Lasso(**kw).fit(jx, jy)
    b = htt.regression.Lasso(**kw).fit(tx, ty)
    return a, b, (jx, jy), (tx, ty)


def _same(a, b, tol):
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), **tol)
    for u, v in zip(a.lshards(), b.lshards()):
        np.testing.assert_allclose(v, u, **tol)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("sweeps", [1, 3])
def test_fixed_sweeps(ht, n, sweeps):
    x, y = _data()
    a, b, _, _ = _fit_both(ht, n, x, y, lam=0.01, max_iter=sweeps, tol=-1.0)
    assert a.n_iter == b.n_iter == sweeps
    _same(a.theta, b.theta, F32)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [0, None])
def test_default_tol_and_results(ht, n, split):
    x, y = _data(seed=1)
    a, b, (jx, jy), (tx, ty) = _fit_both(ht, n, x, y, split=split, lam=0.01)
    assert b.n_iter == a.n_iter
    _same(a.theta, b.theta, F32)
    _same(a.coef_, b.coef_, F32)
    _same(a.intercept_, b.intercept_, F32)
    pa, pb = a.predict(jx), b.predict(tx)
    _same(pa, pb, dict(rtol=0.0, atol=1e-4))
    _same(a.fit_predict(jx, jy), b.fit_predict(tx, ty), dict(rtol=0.0, atol=1e-4))
    np.testing.assert_allclose(b.score(tx, ty), a.score(jx, jy), rtol=1e-5)
    np.testing.assert_allclose(b.rmse(ty, pb), a.rmse(jy, pa), rtol=1e-4)
    assert b.get_params() == a.get_params()


@pytest.mark.parametrize("n", MESHES)
def test_float64_and_int_features(ht, n):
    x, y = _data(m=120, n=6, seed=2, dtype=np.float64)
    a, b, _, _ = _fit_both(ht, n, x, y, lam=0.05, max_iter=20)
    assert b.n_iter == a.n_iter and b.theta.dtype is htt.float64
    _same(a.theta, b.theta, dict(rtol=0.0, atol=1e-12))
    xi = np.random.default_rng(3).integers(-3, 4, size=(60, 4))
    yi = (xi @ np.array([1.0, 0.0, -2.0, 0.5]) + 1.0).reshape(-1, 1).astype(np.float32)
    a, b, _, _ = _fit_both(ht, n, xi, yi, lam=0.01, max_iter=5, tol=-1.0)
    _same(a.theta, b.theta, dict(rtol=0.0, atol=1e-4))


@pytest.mark.parametrize("n", MESHES)
def test_lasso_from_state_predicts_as_jax(ht, n):
    x, y = _data(seed=4)
    jc = ht.parallel.mesh.local_mesh(n)
    jx = ht.array(x, split=0, comm=jc)
    a = ht.regression.Lasso(lam=0.02).fit(jx, ht.array(y, split=0, comm=jc))
    b = htt.regression.lasso_from_state(a.theta.numpy(), a.lam, a.n_iter, device="cpu", comm=htt.MeshComm(n))
    assert b.n_iter == a.n_iter and b.lam == a.lam
    _same(a.theta, b.theta, dict(rtol=0.0, atol=0.0))
    _same(a.predict(jx), b.predict(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu")), dict(rtol=0.0, atol=1e-5))
    with pytest.raises(ValueError):
        htt.regression.lasso_from_state(np.zeros((3, 2)), 0.1, 1)


def test_soft_threshold(ht):
    rho = np.linspace(-1, 1, 13).astype(np.float32)
    a = ht.regression.Lasso(lam=0.3).soft_threshold(ht.array(rho, split=0))
    b = htt.regression.Lasso(lam=0.3).soft_threshold(htt.array(rho, split=0, comm=htt.MeshComm(8), device="cpu"))
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7)
    assert b.split == 0


@pytest.mark.parametrize("nonzero", [False, True])
def test_plain_sweep_against_jax_cd_sweep(ht, nonzero):
    import jax.numpy as jnp
    import importlib

    cd_sweep = importlib.import_module("heat_tpu.regression.lasso")._cd_sweep
    x, y = _data(m=300, n=12, seed=5)
    xa = np.concatenate([np.ones((300, 1), np.float32), x], axis=1)
    theta = (np.random.default_rng(6).normal(size=13) * 0.3 if nonzero else np.zeros(13)).astype(np.float32)
    want = np.asarray(cd_sweep(jnp.asarray(xa), jnp.asarray(y[:, 0]), jnp.asarray(theta), 0.05))
    xt = torch.from_numpy(np.ascontiguousarray(xa.T))
    got = k5.reference_sweep(xt, torch.from_numpy(y[:, 0]), torch.from_numpy(theta), 0.05)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = k5.launches
    again = k5.sweep(xt, torch.from_numpy(y[:, 0]), torch.from_numpy(theta), 0.05)
    assert k5.launches == before
    np.testing.assert_array_equal(again.numpy(), got.numpy())


# ------------------------------------------------ K5's blocked order, emulated
# The kernel (csrc/lasso_sweep.cu) takes the coordinates in blocks of b and
# meets once per block: one cooperative launch of min(ceil(m / threads),
# SMs) CTAs, each owning rows_per_block = ceil(m / CTAs) contiguous rows.
# Each CTA sums c'_j = x_j . (r_B + theta_j x_j) (theta_j x_j added element
# by element) and the strictly lower Gram G_ji = x_j . x_i over its rows;
# every CTA adds the CTAs' partials in CTA order and solves the block in
# order, rho_j m = c'_j + sum_{i<j} G_ji d_i; then r += sum_i d_i x_i in
# coordinate order before the next block.

_K5_SRC = (Path(__file__).resolve().parent.parent / "heat_tpu_torch" / "csrc" / "lasso_sweep.cu").read_text()
K5_B = int(re.search(r"constexpr int kB = (\d+);", _K5_SRC).group(1))
K5_THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _K5_SRC).group(1))
H100_SMS = 132


def _blocked_sweep(xt, y, theta, lam, b, threads, sms=H100_SMS):
    """One sweep in K5's blocked order, in float32 torch."""
    n, m = xt.shape
    ctas = min(-(-m // threads), sms)
    rows = -(-m // ctas)
    cuts = [(c * rows, min(m, (c + 1) * rows)) for c in range(ctas) if c * rows < m]
    r = y - torch.matmul(theta, xt)
    th = theta.clone()
    d_prev = None
    for j0 in range(0, n, b):
        nb = min(b, n - j0)
        if d_prev is not None:
            for k in range(b):
                r = r + d_prev[k] * xt[j0 - b + k]
        xb, thb = xt[j0 : j0 + nb], th[j0 : j0 + nb].clone()
        c = torch.zeros(nb, dtype=xt.dtype)
        g = torch.zeros(nb, nb, dtype=xt.dtype)
        for lo, hi in cuts:  # the CTAs' partials, added in CTA order
            xs = xb[:, lo:hi]
            c = c + (xs * (r[lo:hi] + thb[:, None] * xs)).sum(1)
            g = g + torch.tril(xs @ xs.T, diagonal=-1)
        d = torch.zeros(b, dtype=xt.dtype)
        for j in range(nb):
            s = c[j]
            for i in range(j):
                s = s + g[j, i] * d[i]
            rho = s / m
            new = rho if j0 + j == 0 else torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)
            d[j] = thb[j] - new
            th[j0 + j] = new
        d_prev = d
    return th


def _augmented(m, features, seed):
    x, y = _data(m=m, n=features, seed=seed)
    return np.concatenate([np.ones((m, 1), np.float32), x], axis=1), y[:, 0]


@pytest.mark.parametrize("b", sorted({4, K5_B, 16}))
@pytest.mark.parametrize("n_of_b", ["b-1", "b", "b+1", "2b+1"])
@pytest.mark.parametrize("nonzero", [False, True])
def test_blocked_sweep_emulation_against_jax_cd_sweep(ht, b, n_of_b, nonzero):
    import importlib

    import jax.numpy as jnp

    cd_sweep = importlib.import_module("heat_tpu.regression.lasso")._cd_sweep
    n = {"b-1": b - 1, "b": b, "b+1": b + 1, "2b+1": 2 * b + 1}[n_of_b]
    # the intercept, coordinate 0, lies inside the first block; the
    # geometries: the kernel's (2 CTAs at 600 rows), 132 CTAs of 5 rows, and
    # fewer rows (90) than the card's 132 CTAs, one row a CTA
    for m, threads in ((600, K5_THREADS), (600, 4), (90, 1)):
        xa, y = _augmented(m, n - 1, seed=n + m)
        theta = (np.random.default_rng(n).normal(size=n) * 0.3 if nonzero else np.zeros(n)).astype(np.float32)
        want = np.asarray(cd_sweep(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(theta), 0.01))
        xt = torch.from_numpy(np.ascontiguousarray(xa.T))
        got = _blocked_sweep(xt, torch.from_numpy(y), torch.from_numpy(theta), 0.01, b, threads)
        np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=1e-5)


def test_sweep_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        k5.sweep(torch.zeros(3, 10), torch.zeros(9), torch.zeros(3), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(9_999, 37), (100, 3), (1, 2), (7_000_000, 5)])
@pytest.mark.parametrize("nonzero", [False, True])
def test_kernel_matches_plain_on_card(cuda, shape, nonzero):
    m, n = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    xt = torch.randn(n, m, generator=g, device=cuda)
    y = torch.randn(m, generator=g, device=cuda)
    theta = 0.1 * torch.randn(n, generator=g, device=cuda) if nonzero else torch.zeros(n, device=cuda)
    before = k5.launches
    got = k5.sweep(xt, y, theta, 0.01)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    want = k5.reference_sweep(xt, y, theta, 0.01)
    assert float((got - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n_of_b", ["1", "b-1", "b", "b+1", "2b+1", "3b"])
@pytest.mark.parametrize("nonzero", [False, True])
def test_kernel_blocks_of_coordinates_on_card(cuda, n_of_b, nonzero):
    # n around the kernel's block width b, at one CTA a SM (2e5 rows) and
    # at X_B kept in shared memory; reruns are bitwise equal
    b = K5_B
    n = {"1": 1, "b-1": b - 1, "b": b, "b+1": b + 1, "2b+1": 2 * b + 1, "3b": 3 * b}[n_of_b]
    g = torch.Generator(device=cuda).manual_seed(n)
    for m in (200_000, 77):
        xt = torch.randn(n, m, generator=g, device=cuda)
        y = torch.randn(m, generator=g, device=cuda)
        theta = 0.1 * torch.randn(n, generator=g, device=cuda) if nonzero else torch.zeros(n, device=cuda)
        got, again = k5.sweep(xt, y, theta, 1e-3), k5.sweep(xt, y, theta, 1e-3)
        torch.cuda.synchronize()
        want = k5.reference_sweep(xt, y, theta, 1e-3)
        assert torch.equal(got, again)
        assert float((got - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1e-3)


@pytest.mark.gpu
def test_fit_launches_and_matches_cpu_on_card(cuda):
    x, y = _data(m=5000, n=30, seed=7)
    before = k5.launches
    on_card = htt.regression.Lasso(lam=0.01, max_iter=6, tol=-1.0).fit(htt.array(x, split=0), htt.array(y, split=0))
    torch.cuda.synchronize()
    assert k5.launches == before + 6 and on_card.n_iter == 6
    on_cpu = htt.regression.Lasso(lam=0.01, max_iter=6, tol=-1.0).fit(
        htt.array(x, split=0, device="cpu"), htt.array(y, split=0, device="cpu")
    )
    np.testing.assert_allclose(on_card.theta.numpy(), on_cpu.theta.numpy(), rtol=0.0, atol=1e-5)
