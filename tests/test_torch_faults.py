"""Parity faults F4–F7 of heat_tpu_torch against heat_tpu on the CPU.

* F4: ``numpy()``, ``__array__`` and ``lshards()`` of a bfloat16 array give
  an ``ml_dtypes.bfloat16`` array of the same bits, as heat_tpu's do; the
  port imports ``ml_dtypes`` only for that.
* F5: ``array`` of an ``ml_dtypes.bfloat16`` ndarray keeps the dtype and the
  bits, so fitted bf16 state crosses from heat_tpu.
* F6: ``argmin`` of bool is the index of the first False, at every split,
  axis and keepdims.
* F7: ``lt``/``le``/``gt``/``ge``, ``min``, ``sort`` and ``unique`` order
  complex values as NumPy does: real parts first, then imaginary parts.

Every comparison is exact: these are orderings, selections and bit copies.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import heat_tpu_torch as htt

ml_dtypes = pytest.importorskip("ml_dtypes")
BF16 = ml_dtypes.bfloat16
ROOT = Path(__file__).resolve().parent.parent
MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _pair(ht, x, n, split):
    a = ht.array(x, split=split, comm=ht.parallel.mesh.local_mesh(n))
    b = htt.array(x, split=split, comm=htt.MeshComm(n), device="cpu")
    return a, b


def _bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))


def _bf16_data(shape=(13, 3)):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 100).astype(np.float32).astype(BF16)
    x.flat[0] = -0.0
    x.flat[1] = np.inf
    return x


# ------------------------------------------------------------------ F4, F5
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_bf16_array_numpy_and_lshards(ht, n, split):
    x = _bf16_data()
    a, b = _pair(ht, x, n, split)
    assert b.dtype is htt.bfloat16 and a.dtype.__name__ == "bfloat16"
    _bits_equal(b.numpy(), a.numpy())
    _bits_equal(np.asarray(b), x)
    sa, sb = a.lshards(), b.lshards()
    if split is None:
        sa = sa[:1]
    assert len(sb) == len(sa)
    for got, want in zip(sb, sa):
        _bits_equal(got, want)


@pytest.mark.parametrize("n", MESHES)
def test_bf16_cast_result_reads_back(ht, n):
    x = np.linspace(-3, 3, 26, dtype=np.float32).reshape(13, 2)
    a, b = _pair(ht, x, n, 0)
    _bits_equal(b.astype(htt.bfloat16).numpy(), a.astype(ht.bfloat16).numpy())
    assert htt.array(x, dtype=BF16, device="cpu").dtype is htt.bfloat16


def test_bf16_numpy_names_ml_dtypes_when_missing(monkeypatch):
    b = htt.array(_bf16_data(), device="cpu")
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        b.numpy()


def test_import_does_not_load_ml_dtypes():
    code = "import sys, heat_tpu_torch; print(sorted(m for m in sys.modules if m.startswith('ml_dtypes')))"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("n", MESHES)
def test_bf16_fitted_state_crosses_from_jax(ht, n):
    rng = np.random.default_rng(3)
    centres = np.array([[-4.0, 0.0], [4.0, 1.0], [0.0, 5.0]], np.float32)
    x = np.concatenate([rng.normal(c, 0.5, size=(30, 2)) for c in centres]).astype(BF16)
    a = ht.cluster.KMeans(n_clusters=3, init=ht.array(x[[0, 30, 60]]), max_iter=10)
    a.fit(ht.array(x, split=0))
    state = a.cluster_centers_.numpy()
    assert state.dtype == BF16
    b = htt.cluster.kmeans_from_state(state, a.n_iter_, a.inertia_, device="cpu", comm=htt.MeshComm(n))
    assert b.cluster_centers_.dtype is htt.bfloat16
    _bits_equal(b.cluster_centers_.numpy(), state)
    new = x[rng.permutation(len(x))[:25]]
    pa = a.predict(ht.array(new, split=0))
    pb = b.predict(htt.array(new, split=0, comm=htt.MeshComm(n), device="cpu"))
    np.testing.assert_array_equal(pb.numpy(), pa.numpy())


# ----------------------------------------------------------------------- F6
BOOLS = np.array([[True, False, True], [True, True, True], [False, True, True], [True, True, False],
                  [True, True, True]])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis, keepdims", [(None, False), (0, False), (1, False), (0, True), (1, True)])
def test_argmin_of_bool_is_the_first_false(ht, n, split, axis, keepdims, fused):
    with htt.fusion.fuse(fused):
        a, b = _pair(ht, BOOLS, n, split)
        want = ht.argmin(a, axis=axis, keepdims=keepdims)
        got = htt.argmin(b, axis=axis, keepdims=keepdims)
        assert got.shape == want.shape and got.split == want.split
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got.numpy(), np.argmin(BOOLS, axis=axis, keepdims=keepdims))


@pytest.mark.parametrize("n", MESHES)
def test_argmin_of_all_true_is_zero(ht, n):
    x = np.ones(11, bool)
    a, b = _pair(ht, x, n, 0)
    assert int(htt.argmin(b).numpy()) == int(ht.argmin(a).numpy()) == 0


# ----------------------------------------------------------------------- F7
def _complex(size=23, seed=5):
    # few distinct real and imaginary parts: many ties on the real part
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, size) + 1j * rng.integers(-2, 3, size)).astype(np.complex64)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge"])
def test_complex_comparisons(ht, n, split, op):
    x, y = _complex(seed=5), _complex(seed=6)
    (a, b), (c, d) = _pair(ht, x, n, split), _pair(ht, y, n, split)
    want = getattr(ht, op)(a, c)
    got = getattr(htt, op)(b, d)
    assert got.split == want.split and got.dtype is htt.bool
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), getattr(np, {"lt": "less", "le": "less_equal",
                                                            "gt": "greater", "ge": "greater_equal"}[op])(x, y))
    scalar = getattr(htt, op)(b, 0.0 + 1.0j)
    np.testing.assert_array_equal(scalar.numpy(), getattr(ht, op)(a, 0.0 + 1.0j).numpy())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_complex_min(ht, n, split, axis):
    x = _complex(size=33).reshape(11, 3)
    a, b = _pair(ht, x, n, split)
    want = ht.min(a, axis=axis)
    got = htt.min(b, axis=axis)
    assert got.shape == want.shape and got.split == want.split and got.dtype is htt.complex64
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.min(x, axis=axis))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_complex_sort(ht, n, split):
    x = _complex(size=29)
    a, b = _pair(ht, x, n, split)
    (va, ia), (vb, ib) = ht.sort(a), htt.sort(b)
    np.testing.assert_array_equal(vb.numpy(), va.numpy())
    np.testing.assert_array_equal(vb.numpy(), np.sort(x))
    np.testing.assert_array_equal(ib.numpy(), ia.numpy())
    np.testing.assert_array_equal(ib.numpy(), np.argsort(x, kind="stable"))
    assert [s.shape for s in vb.lshards()] == [s.shape for s in va.lshards()]


@pytest.mark.parametrize("n", MESHES)
def test_complex_sort_along_another_axis(ht, n):
    x = _complex(size=33).reshape(11, 3)
    a, b = _pair(ht, x, n, 1)
    va, vb = ht.sort(a, axis=0)[0], htt.sort(b, axis=0)[0]
    np.testing.assert_array_equal(vb.numpy(), va.numpy())
    np.testing.assert_array_equal(vb.numpy(), np.sort(x, axis=0))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_complex_unique(ht, n, split):
    x = _complex(size=31)
    a, b = _pair(ht, x, n, split)
    ua, inva = ht.unique(a, return_inverse=True)
    ub, invb = htt.unique(b, return_inverse=True)
    np.testing.assert_array_equal(ub.numpy(), ua.numpy())
    np.testing.assert_array_equal(ub.numpy(), np.unique(x))
    np.testing.assert_array_equal(invb.numpy().ravel(), inva.numpy().ravel())
    np.testing.assert_array_equal(ub.numpy()[invb.numpy().ravel()], x)


def test_complex_argmin_raises_as_in_jax(ht):
    x = _complex()
    a, b = _pair(ht, x, 4, 0)
    with pytest.raises(TypeError):
        ht.argmin(a).numpy()
    with pytest.raises(RuntimeError):
        htt.argmin(b).numpy()


# -------------------------------------------------------------- F12, F13
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("fname", ["var", "std", "skew", "kurtosis"])
def test_moments_keep_a_length_one_split(ht, n, fname, fused):
    """F12: a moment along another axis than a split axis of length ≤ 1
    keeps the split, as heat_tpu does; the values stay (within rounding of
    the sums)."""
    with htt.fusion.fuse(fused):
        rng = np.random.default_rng(3)
        for shape, split, axis in (((1, 4), 0, 1), ((3, 1), 1, 0), ((1, 4, 2), 0, 2)):
            x = rng.normal(size=shape).astype(np.float32)
            a, b = _pair(ht, x, n, split)
            want, got = getattr(ht, fname)(a, axis=axis), getattr(htt, fname)(b, axis=axis)
            assert got.split == want.split == 0 and got.shape == want.shape, (shape, split, axis)
            np.testing.assert_allclose(got.numpy(), np.asarray(want.larray), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", MESHES)
def test_sort_and_nonzero_of_a_0d_array_raise(ht, n):
    """F13: ``sort`` and ``nonzero`` of a 0-d array raise ``ValueError``, as
    numpy and heat_tpu do."""
    a, b = _pair(ht, np.float32(3.0), n, None)
    for fname in ("sort", "nonzero"):
        with pytest.raises(ValueError):
            getattr(ht, fname)(a)
        with pytest.raises(ValueError):
            getattr(htt, fname)(b)
