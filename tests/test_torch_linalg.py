"""Linear-algebra basics and the ops under the Lasso user's normalisation:
heat_tpu_torch against heat_tpu on the CPU, at meshes 1, 4 and 8.

The same numpy inputs go to both packages.  Shapes, dtypes, splits and
per-position shards must agree exactly; float32 values to rtol 1e-5 (atol
1e-6), because sums and products are taken in different orders (an inner
split sums per-position partial products); integer and float64 values to
1e-12.  Shapes are uneven on purpose: 13 rows over 8 positions leave
shards of 2, 2, 2, 2, 2, 2, 1 and 0 rows.
"""

import numpy as np
import pytest

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
SPLITS = (None, 0, 1)
F32 = dict(rtol=1e-5, atol=1e-6)


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _arrays(ht, n, x, split):
    jc, tc = _pair(ht, n)
    return ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")


def _same(a, b, **tol):
    """Shape, dtype, split, global values and shards of a heat_tpu array
    ``a`` and a heat_tpu_torch array ``b``."""
    tol = tol or dict(rtol=1e-12, atol=0.0)
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), **tol)
    sa, sb = a.lshards(), b.lshards()
    assert [s.shape for s in sa] == [s.shape for s in sb]
    for x, y in zip(sa, sb):
        np.testing.assert_allclose(y, x, **tol)


def _rand(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("sa", SPLITS)
@pytest.mark.parametrize("sb", SPLITS)
def test_matmul_split_table(ht, n, sa, sb):
    a, b = _rand(13, 7, seed=1), _rand(7, 5, seed=2)
    ja, ta = _arrays(ht, n, a, sa)
    jb, tb = _arrays(ht, n, b, sb)
    _same(ht.matmul(ja, jb), htt.matmul(ta, tb), **F32)
    np.testing.assert_allclose((ta @ tb).numpy(), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", MESHES)
def test_matmul_vector_and_int(ht, n):
    a, v = _rand(13, 7, seed=3), _rand(7, seed=4)
    ja, ta = _arrays(ht, n, a, 0)
    jv, tv = _arrays(ht, n, v, None)
    _same(ht.matmul(ja, jv), htt.matmul(ta, tv), **F32)
    ai = np.arange(91, dtype=np.int64).reshape(13, 7)
    ja, ta = _arrays(ht, n, ai, 1)
    jb, tb = _arrays(ht, n, ai.T.copy(), 0)
    _same(ht.matmul(ja, jb), htt.matmul(ta, tb))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_dot(ht, n, split):
    u, v = _rand(13, seed=5), _rand(13, seed=6)
    ju, tu = _arrays(ht, n, u, split)
    jv, tv = _arrays(ht, n, v, 0)
    _same(ht.dot(ju, jv), htt.dot(tu, tv), **F32)
    a, b = _rand(13, 4, seed=7), _rand(4, 3, seed=8)
    _same(ht.dot(*_arrays(ht, n, a, split)[:1], ht.array(b, comm=_pair(ht, n)[0])),
          htt.dot(_arrays(ht, n, a, split)[1], htt.array(b, comm=htt.MeshComm(n), device="cpu")), **F32)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_transpose_and_T(ht, n, split):
    x = _rand(13, 5, seed=9)
    jx, tx = _arrays(ht, n, x, split)
    _same(ht.linalg.transpose(jx), htt.linalg.transpose(tx))
    _same(jx.T, tx.T)
    x3 = _rand(3, 13, 2, seed=10)
    jx, tx = _arrays(ht, n, x3, split)
    _same(ht.linalg.transpose(jx, (1, 2, 0)), htt.linalg.transpose(tx, (1, 2, 0)))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("k", [-2, 0, 3])
def test_tril_triu(ht, n, split, k):
    x = _rand(13, 9, seed=11)
    jx, tx = _arrays(ht, n, x, split)
    _same(ht.tril(jx, k), htt.tril(tx, k))
    _same(ht.triu(jx, k), htt.triu(tx, k))
    jv, tv = _arrays(ht, n, _rand(6, seed=12), None if split is None else 0)
    _same(ht.tril(jv, k), htt.tril(tv, k))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_norms(ht, n, split):
    x = _rand(13, 6, seed=13)
    jx, tx = _arrays(ht, n, x, split)
    _same(ht.linalg.norm(jx), htt.linalg.norm(tx), **F32)
    for axis in (0, 1):
        for ord in (None, 1, 2):
            _same(ht.linalg.norm(jx, axis=axis, ord=ord), htt.linalg.norm(tx, axis=axis, ord=ord), **F32)
        _same(
            ht.linalg.vector_norm(jx, axis=axis, keepdims=True), htt.linalg.vector_norm(tx, axis=axis, keepdims=True),
            **F32,
        )
    _same(ht.linalg.norm(jx, ord="fro"), htt.linalg.norm(tx, ord="fro"), **F32)
    _same(ht.linalg.matrix_norm(jx), htt.linalg.matrix_norm(tx), **F32)
    _same(ht.linalg.matrix_norm(jx, ord=1), htt.linalg.matrix_norm(tx, ord=1), **F32)
    ji, ti = _arrays(ht, n, np.arange(13, dtype=np.int64), None if split is None else 0)
    _same(ht.linalg.norm(ji), htt.linalg.norm(ti), **F32)


# the dtype rules do not depend on the layout: one replicated and one
# uneven split layout per dtype
@pytest.mark.parametrize("n, split", [(1, None), (4, 0)])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.bool_, np.float32, np.float64])
def test_div_pow_sqrt_dtypes(ht, n, split, dtype):
    x = (np.arange(1, 14) % 5 + 1).astype(dtype)
    jx, tx = _arrays(ht, n, x, split)
    for jr, tr in [
        (jx / jx, tx / tx),
        (jx / 2, tx / 2),
        (jx / 2.0, tx / 2.0),
        (3 / jx, 3 / tx),
        (jx**0.5, tx**0.5),
        (ht.sqrt(jx), htt.sqrt(tx)),
    ]:
        _same(jr, tr, **F32)
    if dtype is not np.bool_:
        _same(jx**2, tx**2)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_mean(ht, n, split, dtype):
    x = (_rand(13, 5, seed=14) * 10).astype(dtype)
    jx, tx = _arrays(ht, n, x, split)
    for axis, keepdims in [(None, False), (0, False), (1, True), ((0, 1), True)]:
        _same(ht.mean(jx, axis=axis, keepdims=keepdims), htt.mean(tx, axis=axis, keepdims=keepdims), **F32)


@pytest.mark.parametrize("n", MESHES)
def test_lasso_normalisation(ht, n):
    # the Lasso user's feature scaling: X / sqrt(mean(X**2, axis=0))
    x = _rand(13, 6, seed=15)
    jx, tx = _arrays(ht, n, x, 0)
    _same(jx / ht.sqrt(ht.mean(jx**2, axis=0)), tx / htt.sqrt(htt.mean(tx**2, axis=0)), **F32)
    jn = ht.sqrt(ht.mean(jx * jx, axis=0)) + 1e-12
    tn = htt.sqrt(htt.mean(tx * tx, axis=0)) + 1e-12
    _same(jx / ht.reshape(jn, (1, -1)), tx / htt.reshape(tn, (1, -1)), **F32)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_reshape(ht, n, split):
    x = np.arange(13 * 6, dtype=np.float32).reshape(13, 6)
    jx, tx = _arrays(ht, n, x, split)
    for shape in [(6, 13), (-1,), (13, 2, 3)]:
        _same(ht.reshape(jx, shape), htt.reshape(tx, shape))
    _same(ht.reshape(jx, 6, 13, new_split=1), htt.reshape(tx, 6, 13, new_split=1))
    with pytest.raises(ValueError):
        htt.reshape(tx, (5, 5))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("s1", SPLITS)
@pytest.mark.parametrize("s2", SPLITS)
def test_concatenate(ht, n, s1, s2):
    a, b = _rand(13, 3, seed=16), _rand(13, 2, seed=17)
    ja, ta = _arrays(ht, n, a, s1)
    jb, tb = _arrays(ht, n, b, s2)
    _same(ht.concatenate([ja, jb], axis=1), htt.concatenate([ta, tb], axis=1))
    jc, tc = _arrays(ht, n, _rand(5, 3, seed=18), s2)
    _same(ht.concatenate([ja, jc], axis=0), htt.concatenate([ta, tc], axis=0))
    ji, ti = _arrays(ht, n, np.ones((13, 2), np.int64), s2)
    _same(ht.concatenate([ja, ji], axis=1), htt.concatenate([ta, ti], axis=1))
    with pytest.raises(ValueError):
        htt.concatenate([ta, tc], axis=1)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_basic_getitem(ht, n, split):
    x = _rand(13, 5, seed=19)
    jx, tx = _arrays(ht, n, x, split)
    for key in [-1, slice(2, 11, 3), (Ellipsis, 0), (slice(None), slice(1, None, 2)), (None, slice(1, 3), 1)]:
        _same(jx[key], tx[key])
    theta = _rand(6, 1, seed=20)
    jt, tt = _arrays(ht, n, theta, None)
    _same(jt[1:], tt[1:])
    _same(jt[0], tt[0])
    with pytest.raises(IndexError):
        tx[13]
    with pytest.raises(TypeError):
        tx[np.array([0, 1])]
