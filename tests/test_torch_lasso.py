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
