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


# ------------------------------------------------------------------ columnsort
COLUMNSORT_CASES = {
    "floats": lambda rng: rng.standard_normal(1000).astype(np.float32),
    "ties": lambda rng: rng.integers(0, 7, 1200).astype(np.int32),
    "short-tail": lambda rng: (rng.random(790) < 0.5).astype(np.float32),
}


@pytest.mark.parametrize("method", ("columnsort", "network"))
@pytest.mark.parametrize("case", list(COLUMNSORT_CASES))
def test_columnsort_matches_heat_tpu(ht, case, method):
    """At mesh 8 both of heat_tpu's methods give the port's permutation,
    whichever method the port takes: values and int32 indices bitwise."""
    import jax
    import jax.numpy as jnp
    from heat_tpu.parallel.sort import distributed_sort

    a = COLUMNSORT_CASES[case](np.random.default_rng(len(case)))
    n = a.size
    jc = ht.parallel.mesh.local_mesh(8)
    per = -(-n // 8)
    phys = np.zeros(per * 8, a.dtype)
    phys[:n] = a
    vj, ij = (np.asarray(o)[:n] for o in distributed_sort(
        jax.device_put(jnp.asarray(phys), jc.sharding(0, 1)), jc.mesh, jc.split_axis, 0, n, method=method)[:2])
    shards = htt.array(a, split=0, comm=htt.MeshComm(8), device="cpu").shards
    vt, it, _ = psort.distributed_sort(shards, 0, method=method)
    assert [v.shape[0] for v in vt] == [s.shape[0] for s in shards]
    np.testing.assert_array_equal(torch.cat(vt).numpy(), vj)
    np.testing.assert_array_equal(torch.cat(it).numpy(), ij)
    assert all(i.dtype == torch.int32 for i in it)


def test_columnsort_dispatch_and_bound(ht, monkeypatch):
    from heat_tpu.parallel.sort import columnsort_applicable

    for s in (4, 6, 8):
        for per in (10, 49, 50, 97, 98, 99, 400):
            assert psort.columnsort_applicable(s, per) == columnsort_applicable(s, per), (s, per)
    # "auto" takes the network even where columnsort applies (every
    # position lies on one device, where the network is never slower);
    # "columnsort" forces it at mesh 8 with a padded block of 98 rows
    taken = []
    real = psort._columnsort
    monkeypatch.setattr(psort, "_columnsort", lambda *a: taken.append(a[-1]) or real(*a))
    x = _ties((8 * 98,), seed=3)
    b = htt.array(x, split=0, comm=htt.MeshComm(8), device="cpu")
    vals, _ = htt.sort(b)
    assert taken == []
    np.testing.assert_array_equal(vals.numpy(), np.sort(x, kind="stable"))
    forced, _, _ = psort.distributed_sort(b.shards, 0, method="columnsort")
    assert taken == [98]
    np.testing.assert_array_equal(torch.cat(forced).numpy(), np.sort(x, kind="stable"))
    with pytest.raises(ValueError, match=r"2\(s-1\)\^2 = 98"):
        psort.distributed_sort(htt.array(x[:80], split=0, comm=htt.MeshComm(8), device="cpu").shards, 0,
                               method="columnsort")
    with pytest.raises(ValueError, match="unknown sort method"):
        psort.distributed_sort(b.shards, 0, method="bitonic")
