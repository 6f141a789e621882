"""Parity of heat_tpu_torch's runtime core with heat_tpu on the CPU.

The same numpy inputs go to heat_tpu (JAX on the conftest CPU mesh, cut to
the same number of positions) and to heat_tpu_torch on the CPU at mesh sizes
1, 4 and 8.  Global values, dtypes, splits and per-position shards must
agree: exactly for integers and layouts, to 1e-6 relative for f32 sums
(the two sum in different orders)."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests (the tests that
    need only the card run without it)."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
SHAPES = ((13,), (13, 3), (8, 5), (3, 13))


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _same(a, b, rtol=0.0):
    """Global values, shape, dtype, split and shards of a heat_tpu array
    ``a`` and a heat_tpu_torch array ``b``."""
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=rtol)
    sa, sb = a.lshards(), b.lshards()
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x.shape == y.shape
        np.testing.assert_allclose(y, x, rtol=rtol)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_and_lshape_map(ht, n, shape):
    jc, tc = _pair(ht, n)
    for split in [None] + list(range(len(shape))):
        np.testing.assert_array_equal(tc.lshape_map(shape, split), jc.lshape_map(shape, split))
        for r in range(n):
            assert tc.chunk(shape, split, rank=r) == jc.chunk(shape, split, rank=r)


def test_thirteen_rows_over_eight():
    assert [m[0] for m in htt.MeshComm(8).lshape_map((13, 2), 0)] == [2, 2, 2, 2, 2, 2, 1, 0]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_lshards(ht, n, split):
    jc, tc = _pair(ht, n)
    data = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    a = ht.array(data, split=split, comm=jc)
    b = htt.array(data, split=split, comm=tc, device="cpu")
    _same(a, b)
    np.testing.assert_array_equal(b.lshape_map, a.lshape_map)


@pytest.mark.parametrize("n", MESHES)
def test_arange_plus_ones_smoke(ht, n):
    jc, tc = _pair(ht, n)
    a = ht.arange(10, split=0, comm=jc) + ht.ones(10, split=0, comm=jc)
    b = htt.arange(10, split=0, comm=tc, device="cpu") + htt.ones(10, split=0, comm=tc, device="cpu")
    _same(a, b)
    np.testing.assert_array_equal(b.numpy(), np.arange(1, 11))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_binary_ops_broadcast_and_dominance(ht, n, split):
    jc, tc = _pair(ht, n)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(13, 3)).astype(np.float32)
    row = rng.normal(size=(3,)).astype(np.float32)
    a, b = ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")
    _same(a - ht.array(row, comm=jc), b - htt.array(row, comm=tc, device="cpu"), rtol=1e-6)
    _same(a * 2.5, b * 2.5, rtol=1e-6)
    _same(ht.array(row, comm=jc) + a, htt.array(row, comm=tc, device="cpu") + b, rtol=1e-6)
    _same(a < 0.0, b < 0.0)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sum_min_argmin(ht, n, split, dtype):
    jc, tc = _pair(ht, n)
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, size=(13, 3)).astype(dtype)
    a, b = ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")
    for axis in (None, 0, 1):
        for keepdims in (False, True):
            _same(ht.sum(a, axis=axis, keepdims=keepdims), htt.sum(b, axis=axis, keepdims=keepdims), rtol=1e-6)
            _same(ht.min(a, axis=axis, keepdims=keepdims), htt.min(b, axis=axis, keepdims=keepdims))
            _same(ht.argmin(a, axis=axis, keepdims=keepdims), htt.argmin(b, axis=axis, keepdims=keepdims))


@pytest.mark.parametrize("n", MESHES)
def test_argmin_first_minimum_across_positions(ht, n):
    # ties across shard boundaries: the first minimum along the axis wins
    x = np.array([3, 1, 2, 1, 0, 5, 0, 0, 9, 0, 7, 0, 4], dtype=np.float32)
    jc, tc = _pair(ht, n)
    a, b = ht.array(x, split=0, comm=jc), htt.array(x, split=0, comm=tc, device="cpu")
    _same(ht.argmin(a, axis=0), htt.argmin(b, axis=0))
    assert int(htt.argmin(b, axis=0).item()) == 4


@pytest.mark.parametrize("n", MESHES)
def test_resplit_roundtrip(ht, n):
    jc, tc = _pair(ht, n)
    x = np.arange(13 * 5, dtype=np.float32).reshape(13, 5)
    a, b = ht.array(x, split=0, comm=jc), htt.array(x, split=0, comm=tc, device="cpu")
    for axis in (None, 0, 1, None, 0):
        a.resplit_(axis)
        b.resplit_(axis)
        _same(a, b)


@pytest.mark.parametrize("n", MESHES)
def test_astype(ht, n):
    jc, tc = _pair(ht, n)
    x = np.arange(13, dtype=np.int32)
    a, b = ht.array(x, split=0, comm=jc), htt.array(x, split=0, comm=tc, device="cpu")
    _same(a.astype(ht.float32), b.astype(htt.float32))
    b.astype(htt.float64, copy=False)
    assert b.dtype is htt.float64 and all(s.dtype == torch.float64 for s in b.shards)


def test_factories_zero_length_shards():
    tc = htt.MeshComm(8)
    for fill, value in ((htt.zeros, 0.0), (htt.ones, 1.0)):
        z = fill((13, 2), split=0, comm=tc, device="cpu")
        assert [s.shape[0] for s in z.shards] == [2, 2, 2, 2, 2, 2, 1, 0]
        np.testing.assert_array_equal(z.numpy(), np.full((13, 2), value, np.float32))
    assert htt.empty((3, 4), split=1, comm=tc, device="cpu").lshape_map.tolist() == htt.MeshComm(8).lshape_map((3, 4), 1).tolist()


NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64", "complex64", "complex128"]


@pytest.mark.parametrize("t1", NAMES)
def test_promote_types(ht, t1):
    for t2 in NAMES:
        want = ht.types.promote_types(getattr(ht.types, t1), getattr(ht.types, t2))
        got = htt.types.promote_types(getattr(htt.types, t1), getattr(htt.types, t2))
        assert got.__name__ == want.__name__, (t1, t2)


def test_result_type_scalars(ht):
    for op in (1, 1.5, True):
        for t in ("int32", "float32", "uint8", "bool"):
            want = ht.types.result_type(getattr(ht.types, t), op)
            got = htt.types.result_type(getattr(htt.types, t), op)
            assert got.__name__ == want.__name__, (t, op)


@pytest.mark.parametrize("fn", ["rand", "randn"])
def test_random_seeded_and_mesh_invariant(fn):
    draws = []
    for n in MESHES:
        htt.random.seed(11)
        first = getattr(htt.random, fn)(13, 3, split=0, comm=htt.MeshComm(n), device="cpu")
        second = getattr(htt.random, fn)(13, 3, split=0, comm=htt.MeshComm(n), device="cpu")
        assert [s.shape[0] for s in first.shards] == list(htt.MeshComm(n).lshape_map((13, 3), 0)[:, 0])
        assert not np.array_equal(first.numpy(), second.numpy())
        draws.append((first.numpy(), second.numpy()))
    for d in draws[1:]:
        np.testing.assert_array_equal(d[0], draws[0][0])
        np.testing.assert_array_equal(d[1], draws[0][1])
    if fn == "rand":
        assert draws[0][0].min() >= 0.0 and draws[0][0].max() < 1.0


@pytest.mark.parametrize("n", MESHES)
def test_collectives_over_shard_lists(n):
    parts = [torch.full((2, 3), float(r)) for r in range(n)]
    total = htt.parallel.collectives.psum(parts)
    low = htt.parallel.collectives.pmin(parts)
    whole = htt.parallel.collectives.all_gather(parts, dim=0)
    root = htt.parallel.collectives.bcast(parts, root=n - 1)
    assert len(total) == len(low) == len(whole) == len(root) == n
    for r in range(n):
        torch.testing.assert_close(total[r], torch.full((2, 3), float(sum(range(n)))))
        torch.testing.assert_close(low[r], torch.zeros(2, 3))
        torch.testing.assert_close(whole[r], torch.cat(parts, dim=0))
        torch.testing.assert_close(root[r], parts[n - 1])
