"""Parity of heat_tpu_torch's shape manipulations with heat_tpu's on the
CPU: the functions of heat_tpu/core/manipulations.py beside reshape and
resplit (which tests/test_torch_transport.py holds).

The same numpy arrays go to heat_tpu on the conftest mesh cut to 1, 4 and 8
positions and to the port on the CPU at the same sizes; values, shape,
dtype, split and per-position shards must be equal bitwise (these functions
move data and compute nothing)."""

import numpy as np
import pytest

import heat_tpu_torch as htt

MESHES = (1, 4, 8)
SPLITS = (None, 0, 1)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _same(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split, (a.split, b.split)
    x, y = np.asarray(a.numpy()), b.numpy()
    assert x.dtype == y.dtype
    np.testing.assert_array_equal(np.ascontiguousarray(y).view(np.uint8), np.ascontiguousarray(x).view(np.uint8))
    if x.size == 0:
        assert [v.shape for v in b.lshards()] == ([tuple(m) for m in b.lshape_map] if b.split is not None else [x.shape])
        return
    sa, sb = a.lshards(), b.lshards()
    assert len(sa) == len(sb)
    for u, v in zip(sa, sb):
        np.testing.assert_array_equal(np.ascontiguousarray(v).view(np.uint8), np.ascontiguousarray(np.asarray(u)).view(np.uint8))


def _pair(ht, n, x, split):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    return ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")


def _x(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _both(ht, n, x, split, fname, *args, **kw):
    a, b = _pair(ht, n, x, split)
    _same(getattr(ht, fname)(a, *args, **kw), getattr(htt, fname)(b, *args, **kw))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_axis_moves(ht, n, split):
    x = _x((7, 5, 3), seed=1)
    for fname, args in [
        ("expand_dims", (0,)), ("expand_dims", (1,)), ("expand_dims", (3,)), ("expand_dims", (-1,)),
        ("swapaxes", (0, 1)), ("swapaxes", (1, 2)), ("swapaxes", (0, -1)),
        ("moveaxis", (0, 2)), ("moveaxis", (2, 0)), ("moveaxis", ([0, 1], [2, 0])),
        ("flatten", ()), ("ravel", ()),
    ]:
        _both(ht, n, x, split, fname, *args)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_squeeze(ht, n, split):
    x = _x((7, 1, 3, 1), seed=2)
    for axis in (None, 1, 3, (1, 3)):
        _both(ht, n, x, split, "squeeze", axis)
    y = _x((1, 6), seed=3)
    _both(ht, n, y, split, "squeeze")


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_flips_rolls_rotations(ht, n, split):
    x = _x((7, 5), np.int32, seed=4)
    for fname, args in [
        ("flip", (None,)), ("flip", (0,)), ("flip", (1,)), ("fliplr", ()), ("flipud", ()),
        ("roll", (2,)), ("roll", (3, 0)), ("roll", (-2, 1)), ("roll", ((1, 2), (0, 1))),
        ("rot90", ()), ("rot90", (2,)), ("rot90", (3,)), ("rot90", (1, (1, 0))), ("rot90", (0,)),
    ]:
        _both(ht, n, x, split, fname, *args)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_pad_repeat_tile(ht, n, split):
    x = _x((7, 5), seed=5)
    for fname, args, kw in [
        ("pad", (((1, 2), (0, 0)),), {}), ("pad", (((0, 0), (3, 1)),), {"constant_values": 2.5}),
        ("pad", (1,), {}),
        ("repeat", (2,), {}), ("repeat", (2,), {"axis": 0}), ("repeat", (3,), {"axis": 1}),
        ("repeat", (np.array([1, 0, 2, 1, 1]),), {"axis": 1}),
        ("tile", (2,), {}), ("tile", ((2, 1),), {}), ("tile", ((1, 3),), {}), ("tile", ((2, 1, 2),), {}),
    ]:
        _both(ht, n, x, split, fname, *args, **kw)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_broadcast_and_diagonals(ht, n, split):
    x = _x((7, 1), seed=6)
    for shape in ((7, 4), (3, 7, 4), (2, 7, 1)):
        _both(ht, n, x, split, "broadcast_to", shape)
    y = _x((6, 6), seed=7)
    for offset in (0, 1, -2):
        _both(ht, n, y, split, "diagonal", offset)
        _both(ht, n, y, split, "diag", offset)
    a1, b1 = _pair(ht, n, _x((5,), seed=8), 0 if split is not None else None)
    _same(ht.diag(a1, 1), htt.diag(b1, 1))
    a, b = _pair(ht, n, x, split)
    a2, b2 = _pair(ht, n, _x((7, 4), seed=9), split)
    for u, v in zip(ht.broadcast_arrays(a, a2), htt.broadcast_arrays(b, b2)):
        _same(u, v)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_stack_family(ht, n, split):
    xs = [_x((6, 4), seed=s) for s in (10, 11, 12)]
    ja = [_pair(ht, n, x, split)[0] for x in xs]
    tb = [_pair(ht, n, x, split)[1] for x in xs]
    for axis in (0, 1, 2, -1):
        _same(ht.stack(ja, axis=axis), htt.stack(tb, axis=axis))
    for fname in ("vstack", "hstack", "row_stack", "column_stack", "dstack"):
        _same(getattr(ht, fname)(ja), getattr(htt, fname)(tb))
    vs = [_x((5,), seed=s) for s in (13, 14)]
    s1 = 0 if split is not None else None
    ja1 = [_pair(ht, n, v, s1)[0] for v in vs]
    tb1 = [_pair(ht, n, v, s1)[1] for v in vs]
    for fname in ("stack", "vstack", "hstack", "column_stack", "dstack"):
        _same(getattr(ht, fname)(ja1), getattr(htt, fname)(tb1))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_split_family(ht, n, split):
    x = _x((6, 8, 2), seed=15)
    a, b = _pair(ht, n, x, split)
    for fname, args in [
        ("split", (3,)), ("split", (2, 1)), ("split", ([1, 5],)), ("split", ([2, 3, 7], 1)),
        ("vsplit", (2,)), ("hsplit", (4,)), ("hsplit", ([3],)), ("dsplit", (2,)),
    ]:
        pa, pb = getattr(ht, fname)(a, *args), getattr(htt, fname)(b, *args)
        assert len(pa) == len(pb)
        for u, v in zip(pa, pb):
            _same(u, v)
    with pytest.raises(ValueError):
        htt.split(b, 4)


@pytest.mark.parametrize("n", (1, 4))
def test_balance_redistribute_shape(ht, n):
    x = _x((7, 3), seed=16)
    a, b = _pair(ht, n, x, 0)
    _same(ht.balance(a), htt.balance(b))
    c = htt.balance(b, copy=True)
    _same(a, c)
    assert all(u.data_ptr() != v.data_ptr() for u, v in zip(c.shards, b.shards) if u.numel())
    _same(ht.redistribute(a), htt.redistribute(b))
    assert htt.shape(b) == ht.shape(a) == (7, 3)
    _same(a.flatten(), b.flatten())
    _same(a.squeeze(), b.squeeze())
    _same(a.expand_dims(0), b.expand_dims(0))


def test_errors():
    b = htt.array(_x((6, 4)), split=0, comm=htt.MeshComm(4), device="cpu")
    with pytest.raises(ValueError):
        htt.squeeze(b, 0)
    with pytest.raises(ValueError):
        htt.broadcast_to(b, (5, 4))
    with pytest.raises(ValueError):
        htt.rot90(b, 1, (0, 0))
    # every mode of jnp.pad is ported; an unknown one raises as jnp.pad does
    with pytest.raises(NotImplementedError):
        htt.pad(b, 1, mode="bogus")


@pytest.mark.parametrize("n", MESHES)
def test_linear_ramp_pad_on_one_side(ht, n):
    """F10: an axis padded only after (or only before) in ``linear_ramp``
    mode gives ``np.pad``'s values, as heat_tpu does, on every route: the
    whole axis in one tensor (split None, another axis than the split, one
    position) and the split axis over several."""
    x = _x((9, 5), seed=11)
    for pw in (((0, 4), (2, 1)), ((1, 0), (0, 1))):
        for split in SPLITS:
            a, b = _pair(ht, n, x, split)
            _same(ht.pad(a, pw, mode="linear_ramp"), htt.pad(b, pw, mode="linear_ramp"))
