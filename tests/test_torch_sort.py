"""Parity of heat_tpu_torch's sort, topk and unique with heat_tpu's on the
CPU (the distributed ones over parallel/sort.py).

The same numpy arrays (with ties, NaNs and signed zeros) go to heat_tpu on
the conftest mesh cut to 1, 4 and 8 positions and to the port on the CPU at
the same sizes; values and indices must be equal bitwise, with the same
dtypes and splits (sorting moves data and computes nothing)."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import sort as psort

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _same(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__, (a.dtype, b.dtype)
    assert a.split == b.split, (a.split, b.split)
    x, y = np.asarray(a.numpy()), b.numpy()
    np.testing.assert_array_equal(np.ascontiguousarray(y).view(np.uint8), np.ascontiguousarray(x).view(np.uint8))
    if x.size:
        for u, v in zip(a.lshards(), b.lshards()):
            np.testing.assert_array_equal(np.ascontiguousarray(v).view(np.uint8), np.ascontiguousarray(np.asarray(u)).view(np.uint8))


def _pair(ht, n, x, split):
    return (ht.array(x, split=split, comm=ht.parallel.mesh.local_mesh(n)),
            htt.array(x, split=split, comm=htt.MeshComm(n), device="cpu"))


def _ties(shape, dtype=np.float32, seed=0, special=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, shape).astype(dtype)
    if special and np.issubdtype(dtype, np.floating):
        flat = x.reshape(-1)
        flat[rng.choice(flat.size, 3, replace=False)] = np.nan
        flat[rng.choice(flat.size, 2, replace=False)] = -0.0
    return x


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape,split,axis", [((23,), 0, 0), ((13, 5), 0, 0), ((5, 13), 1, 1), ((13, 5), 0, 1),
                                              ((13, 5), None, 0), ((7, 6, 3), 1, 1)], ids=str)
@pytest.mark.parametrize("descending", (False, True))
def test_sort(ht, n, shape, split, axis, descending):
    x = _ties(shape, seed=1)
    a, b = _pair(ht, n, x, split)
    va, ia = ht.sort(a, axis=axis, descending=descending)
    vb, ib = htt.sort(b, axis=axis, descending=descending)
    _same(va, vb)
    _same(ia, ib)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", (np.int32, np.int64), ids=lambda d: np.dtype(d).name)
def test_sort_integers(ht, n, dtype):
    x = _ties((29,), dtype, seed=2)
    a, b = _pair(ht, n, x, 0)
    for desc in (False, True):
        for u, v in zip(ht.sort(a, descending=desc), htt.sort(b, descending=desc)):
            _same(u, v)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape,split,dim", [((23,), 0, 0), ((13, 5), 0, 0), ((13, 5), 0, 1), ((5, 13), 1, 1),
                                             ((13, 5), None, 0)], ids=str)
@pytest.mark.parametrize("largest", (True, False))
def test_topk(ht, n, shape, split, dim, largest):
    x = _ties(shape, seed=3)
    a, b = _pair(ht, n, x, split)
    k = min(4, shape[dim])
    for u, v in zip(ht.topk(a, k, dim=dim, largest=largest), htt.topk(b, k, dim=dim, largest=largest)):
        _same(u, v)
    with pytest.raises(ValueError):
        htt.topk(b, shape[dim] + 1, dim=dim)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape,split", [((29,), 0), ((29,), None), ((7, 4), 0), ((7, 4), 1)], ids=str)
def test_unique(ht, n, shape, split):
    x = _ties(shape, seed=4)
    a, b = _pair(ht, n, x, split)
    _same(ht.unique(a), htt.unique(b))
    for u, v in zip(ht.unique(a, return_inverse=True), htt.unique(b, return_inverse=True)):
        _same(u, v)


@pytest.mark.parametrize("n", (1, 4))
def test_unique_rows(ht, n):
    x = np.array([[1, 2], [0, 5], [1, 2], [0, 5], [3, 3]], np.int64)
    a, b = _pair(ht, n, x, 0)
    _same(ht.unique(a, axis=0), htt.unique(b, axis=0))


def test_network_sorts_every_chunk_layout():
    # the merge-split network at every mesh size from 1 to 9 and lengths
    # that leave short and empty trailing blocks
    rng = np.random.default_rng(5)
    for S in range(1, 10):
        for n in (0, 1, S - 1, S, 2 * S + 1, 5 * S - 3):
            if n < 0:
                continue
            x = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32))
            b = htt.array(x, split=0, comm=htt.MeshComm(S), device="cpu")
            vals, idx, _ = psort.distributed_sort(b.shards, 0)
            want = torch.sort(x, stable=True)
            assert torch.equal(torch.cat(vals), want.values)
            assert torch.equal(torch.cat(idx).long(), want.indices)
