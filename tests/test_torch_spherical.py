"""``utils.data.spherical.create_spherical_dataset``: heat_tpu_torch against
heat_tpu on the CPU.

Both spherical modules' ``random.rand`` are replaced, inside the test, by
one that returns the same numpy draws as each package's split array, so the
construction is checked apart from the draws (that the draws themselves
are heat_tpu's is tests/test_torch_threefry.py's).  The construction (sin/cos
of the angles, the four shifted copies, the concatenation and resplit)
must agree: 4·n rows at every mesh size, split 0, values to 2 f32 ulps (CPU
sin/cos in the two libraries may round differently)."""

import numpy as np
import pytest

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)


class _Draws:
    """A stand-in for a package's ``random`` module in ``spherical``: the
    same numpy uniforms, in order, as that package's arrays."""

    def __init__(self, pkg, comm, n, seed, device=None):
        rng = np.random.default_rng(seed)
        self._draws = [rng.random(n, dtype=np.float32) for _ in range(3)]
        self._pkg, self._comm, self._device = pkg, comm, device
        self.seeds = []

    def seed(self, s):
        self.seeds.append(s)

    def rand(self, *shape, split=None, **kw):
        extra = {} if self._device is None else {"device": self._device}
        return self._pkg.array(self._draws.pop(0).reshape(shape), split=split, comm=self._comm, **extra)


def _make(monkeypatch, pkg, mod, comm, n, seed, use_comm, device=None, **kw):
    draws = _Draws(pkg, comm, n, seed, device)
    monkeypatch.setattr(mod, "random", draws)
    use_comm(comm)
    try:
        return mod.create_spherical_dataset(n, **kw), draws
    finally:
        use_comm(None)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("rows", [1, 13, 250])
def test_construction_matches_jax(ht, monkeypatch, n, rows):
    import heat_tpu.utils.data.spherical as jmod

    from heat_tpu.parallel.mesh import local_mesh, use_comm as juse

    tmod = htt.utils.data.spherical
    htt.use_device("cpu")
    try:
        a, da = _make(monkeypatch, ht, jmod, local_mesh(n), rows, 7, juse, random_state=3)
        b, db = _make(monkeypatch, htt, tmod, htt.MeshComm(n), rows, 7, htt.use_comm, device="cpu", random_state=3)
    finally:
        htt.use_device("gpu")
    assert da.seeds == db.seeds == [3]
    assert b.shape == a.shape == (4 * rows, 3)
    assert b.split == a.split == 0
    assert b.dtype is htt.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2 * np.finfo(np.float32).eps, atol=1e-6)
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_dtype_and_offsets(ht, monkeypatch, dtype):
    import heat_tpu.utils.data.spherical as jmod

    from heat_tpu.parallel.mesh import local_mesh, use_comm as juse

    tmod = htt.utils.data.spherical
    htt.use_device("cpu")
    try:
        a, _ = _make(monkeypatch, ht, jmod, local_mesh(4), 50, 1, juse, offset=2.0, radius=0.5,
                     dtype=getattr(ht, dtype))
        b, _ = _make(monkeypatch, htt, tmod, htt.MeshComm(4), 50, 1, htt.use_comm, device="cpu", offset=2.0,
                     radius=0.5, dtype=getattr(htt, dtype))
    finally:
        htt.use_device("gpu")
    assert b.dtype.__name__ == a.dtype.__name__ == dtype
    got, want = b.numpy().astype(np.float64), a.numpy().astype(np.float64)
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the four clusters sit at ±offset and ±2·offset along the diagonal
    means = got.reshape(4, 50, 3).mean(axis=1)
    np.testing.assert_allclose(means, [[2] * 3, [4] * 3, [-2] * 3, [-4] * 3], atol=0.5)


def test_public_name_and_real_draws():
    """Through the public name, with the port's own generator: 4·n rows at
    every mesh size, the same rows for one seed, within radius of their
    centres."""
    htt.use_device("cpu")
    try:
        outs = []
        for n in MESHES:
            htt.use_comm(htt.MeshComm(n))
            outs.append(htt.utils.data.spherical.create_spherical_dataset(100, random_state=2))
    finally:
        htt.use_comm(None)
        htt.use_device("gpu")
    for d in outs:
        assert d.shape == (400, 3) and d.split == 0
        np.testing.assert_array_equal(d.numpy(), outs[0].numpy())
    x = outs[0].numpy().reshape(4, 100, 3)
    centres = np.array([4.0, 8.0, -4.0, -8.0])[:, None, None]
    assert np.linalg.norm(x - centres, axis=2).max() <= 1.0 + 1e-5
    assert htt.utils.data.create_spherical_dataset is htt.utils.data.spherical.create_spherical_dataset
