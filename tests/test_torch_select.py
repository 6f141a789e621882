"""Parity of heat_tpu_torch's advanced indexing with heat_tpu's on the CPU:
the mask-select and integer-take routes of ``DNDarray.__getitem__`` (over
``parallel.select`` and the transport engine's take), the generic path for
the keys they decline, and ``nonzero``/``where``.

The same numpy arrays and keys go to heat_tpu on the conftest mesh cut to
1, 4 and 8 positions and to the port on the CPU at the same sizes; values,
shape, dtype, split and per-position shards must be equal bitwise (indexing
moves data and computes nothing)."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _same(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split, (a.split, b.split)
    x, y = np.asarray(a.numpy()), b.numpy()
    assert x.dtype == y.dtype
    np.testing.assert_array_equal(np.ascontiguousarray(y).view(np.uint8), np.ascontiguousarray(x).view(np.uint8))
    sa, sb = a.lshards(), b.lshards()
    if x.size == 0:
        # heat_tpu's physical array of extent 0 has one addressable shard;
        # the port keeps one empty shard per position
        assert [v.shape for v in sb] == [tuple(m) for m in b.lshape_map]
        return
    assert len(sa) == len(sb)
    for u, v in zip(sa, sb):
        u = np.asarray(u)
        assert u.shape == v.shape
        np.testing.assert_array_equal(np.ascontiguousarray(v).view(np.uint8), np.ascontiguousarray(u).view(np.uint8))


def _arrays(ht, n, x, split):
    jc, tc = _pair(ht, n)
    return ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")


def _x(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (0, 1))
@pytest.mark.parametrize("density", (0.0, 0.3, 1.0))
def test_mask_on_the_split_axis(ht, n, split, density):
    x = _x((13, 6), seed=1)
    a, b = _arrays(ht, n, x, split)
    rng = np.random.default_rng(2)
    mask = rng.random(x.shape[split]) < density
    key = mask if split == 0 else (slice(None), mask)
    _same(a[key], b[key])
    # the mask as a list, and as a split DNDarray of its own
    if split == 0:
        _same(a[list(mask)], b[list(mask)])
        _same(a[ht.array(mask, split=0, comm=a.comm)], b[htt.array(mask, split=0, comm=b.comm, device="cpu")])
    else:
        _same(a[..., mask], b[..., mask])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", (np.float32, np.int64, np.bool_), ids=lambda d: np.dtype(d).name)
def test_full_mask_of_a_split0_array(ht, n, dtype):
    x = _x((13, 5), dtype, seed=3)
    a, b = _arrays(ht, n, x, 0)
    mask = _x((13, 5), np.float32, seed=4) > 0.2
    _same(a[mask], b[mask])
    # a split-1 array takes the generic path in both
    a1, b1 = _arrays(ht, n, x, 1)
    _same(a1[mask], b1[mask])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (0, 1))
def test_int_take_host_rows(ht, n, split):
    x = _x((13, 7), seed=5)
    a, b = _arrays(ht, n, x, split)
    ext = x.shape[split]
    rows = np.array([ext - 1, 0, 5, 5, -1, 3, -ext, 1, 0, 2, 4], np.int64)
    key = rows if split == 0 else (slice(None), rows)
    _same(a[key], b[key])
    key = list(rows[:4]) if split == 0 else (Ellipsis, list(rows[:4]))
    _same(a[key], b[key])
    with pytest.raises(IndexError):
        b[np.array([0, ext])] if split == 0 else b[:, np.array([0, ext])]


@pytest.mark.parametrize("n", MESHES)
def test_int_take_device_rows_clamp(ht, n):
    import jax.numpy as jnp

    x = _x((13, 4), seed=6)
    a, b = _arrays(ht, n, x, 0)
    rows = np.array([3, -2, 12, 40, -30, 0], np.int64)
    _same(a[jnp.asarray(rows)], b[torch.from_numpy(rows)])
    # an integer DNDarray key, as a nonzero() product would be
    r2 = np.array([1, 1, 7, 2], np.int64)
    _same(a[ht.array(r2, comm=a.comm)], b[htt.array(r2, comm=b.comm, device="cpu")])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize(
    "shape,split,key",
    [
        ((13, 7), 0, (np.array([0, 12, 3, 3]), np.array([6, 0, 2, 2]))),
        ((13, 7), 0, (np.array([0, 12, 3]), 4)),
        ((7, 13), 1, (np.array([6, 0, 2]), np.array([0, 12, 5]))),
        ((5, 9, 4), 1, (slice(None), np.array([8, 0, 1, 4]), np.array([3, 0, 2, 1]))),
        ((5, 9, 4), 1, (np.array([4, 0, 1, 2]), slice(None), np.array([1, 0, 3, 2]))),
        ((5, 9, 4), 0, (np.array([4, 0, 1]), slice(None), np.array([1, 0, 3]))),
    ],
    ids=str,
)
def test_pair_take(ht, n, shape, split, key):
    # the (rows, cols) route wants its rows on the split dimension; the
    # other keys here reach heat_tpu's generic path, and so the port's
    x = _x(shape, seed=7)
    a, b = _arrays(ht, n, x, split)
    _same(a[key], b[key])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize(
    "split,key",
    [
        (0, (slice(None), [0, 2])),
        (1, ([1, 2], slice(1, 3))),
        (None, ([1, 2], [0, 1])),
        (0, (None, np.array([3, 1]))),
        (0, (np.array([[0, 1], [2, 3]]),)),
        (1, (np.array([0, 1]), np.array([[1], [2]]))),
        (0, (True,)),
        (0, (slice(1, 4), np.array([True, False, True, False, True]))),
    ],
    ids=str,
)
def test_generic_advanced_keys(ht, n, split, key):
    x = _x((6, 5), seed=8)
    a, b = _arrays(ht, n, x, split)
    _same(a[key], b[key])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape,split", [((13,), 0), ((13, 4), 0), ((13, 4), 1), ((5, 6, 3), 2), ((7, 3), None)])
def test_nonzero(ht, n, shape, split):
    x = (_x(shape, seed=9) > 0.4).astype(np.int32)
    a, b = _arrays(ht, n, x, split)
    want = ht.nonzero(a)
    for got in (htt.nonzero(b), b.nonzero(), htt.where(b)):
        _same(want, got)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (None, 0, 1))
def test_where(ht, n, split):
    c = _x((13, 4), seed=10) > 0
    x, y = _x((13, 4), seed=11), _x((13, 4), seed=12)
    jc, tc = _pair(ht, n)
    ca, cb = ht.array(c, split=split, comm=jc), htt.array(c, split=split, comm=tc, device="cpu")
    xa, xb = ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")
    ya, yb = ht.array(y, split=split, comm=jc), htt.array(y, split=split, comm=tc, device="cpu")
    _same(ht.where(ca, xa, ya), htt.where(cb, xb, yb))
    _same(ht.where(ca, xa, 0.0), htt.where(cb, xb, 0.0))
    # an operand of another split meets the gathered condition
    other = 0 if split != 0 else 1
    _same(ht.where(ca, ht.array(x, split=other, comm=jc), ya), htt.where(cb, htt.array(x, split=other, comm=tc, device="cpu"), yb))
    with pytest.raises(TypeError):
        htt.where(cb, xb)


def test_route_keeps_the_input_whole():
    # the mask and take routes build the output from the shards: the input's
    # shards are not replaced or written
    tc = htt.MeshComm(4)
    x = _x((13, 3), seed=13)
    b = htt.array(x, split=0, comm=tc, device="cpu")
    before = [s.clone() for s in b.shards]
    b[x[:, 0] > 0]
    b[np.array([3, 1, 12])]
    for s, t in zip(b.shards, before):
        assert torch.equal(s, t)


def _with_nan(x):
    x = x.copy()
    x[[0, 6, 12], [1, 4, 0]] = np.nan
    return x


NEGATIVE_STEP_KEYS = [
    slice(None, None, -2),
    slice(None, None, -1),
    slice(7, 1, -3),
    (slice(None), slice(None, None, -2)),
    (slice(None, None, -1), slice(1, 4)),
    (3, slice(None, None, -1)),
    (slice(None, None, -3), slice(4, 0, -2)),
    (None, slice(5, None, -1)),
]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("data", ["f32", "f32 nan", "int32"])
def test_negative_slice_steps(ht, n, split, data):
    # a negative step indexes the positive-step range and flips it; a
    # reversed split axis is cut anew by the chunk rule
    x = {"f32": _x((13, 5)), "f32 nan": _with_nan(_x((13, 5))), "int32": _x((13, 5), np.int32)}[data]
    a, b = _arrays(ht, n, x, split)
    for key in NEGATIVE_STEP_KEYS:
        _same(a[key], b[key])
        np.testing.assert_array_equal(b[key].numpy(), x[key])
    # an empty range: heat_tpu's replicated or split result, cut anew
    empty, want = b[2:9:-1], a[2:9:-1]
    assert empty.shape == want.shape == (0, 5) and empty.split == want.split
    assert [tuple(s.shape) for s in empty.shards] == [tuple(m) for m in empty.lshape_map]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("key", [
    (np.array([0, 2, 5, 12]), slice(None, None, -1)),
    (slice(None, None, -2), np.array([1, 3])),
    (slice(11, 2, -4), np.array([4, 0, 4])),
])
def test_negative_slice_steps_with_advanced_keys(ht, n, split, key):
    x = _x((13, 5), seed=3)
    a, b = _arrays(ht, n, x, split)
    _same(a[key], b[key])
    np.testing.assert_array_equal(b[key].numpy(), x[key])
