"""``DNDarray.__setitem__`` of heat_tpu_torch against heat_tpu's on the CPU,
and its K7 route.

Every key form that ``__getitem__`` takes (ints, slices with negative
steps, ``...``, ``None``, host and device integer arrays with negative
entries, row and full boolean masks, DNDarray keys, and mixes) with a
scalar and an ndarray value at splits None/0/1 on meshes 1/4/8 in
float32; a broadcast row, tensor values, DNDarray keys and DNDarray
values in every layout at mesh 4 (and meshes 1 and 8 along split 0);
other dtypes and casts at mesh 4.  The same numpy input goes to both packages; the results and each
position's shard must be equal bitwise (assignment moves data and
computes nothing but a cast).

Where XLA leaves the result undefined, which of several writes to one
element wins (duplicate indices), the tests assert only that the element
holds one of the written values.  Device integer keys out of bounds are
clamped to the extent in both packages; host ones raise.

The K7 route is emulated here: the rechunk plan at explicit destination
bounds against numpy, and ``ops.repack.calls`` (one per destination
position that receives rows) on the routes that take it; the ``gpu``
tests run the kernel itself on the card.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import repack as k7
from heat_tpu_torch.parallel import transport

MESHES = (1, 4, 8)
SHAPE = (9, 6, 4)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _x(shape=SHAPE, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    v = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(dtype)


def _bits(v):
    return np.ascontiguousarray(np.asarray(v)).view(np.uint8)


def _same(a, b):
    """Values, shape, dtype, split and shards, bitwise."""
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_array_equal(_bits(b.numpy()), _bits(a.numpy()))
    sa, sb = a.lshards(), b.lshards()
    assert len(sa) == len(sb)
    for u, v in zip(sa, sb):
        np.testing.assert_array_equal(_bits(v), _bits(u))


X = _x()
M0 = X[:, 0, 0] > 0
M1 = X[0, :, 0] > 0
# host keys; (name, key)
KEYS = [
    ("int", 3),
    ("negative int", -1),
    ("slice", slice(2, 7)),
    ("negative step", slice(None, None, -2)),
    ("step slice", (slice(1, 9, 3), slice(None), 1)),
    ("newaxis", (slice(1, 7), None, 2)),
    ("ellipsis", (Ellipsis, 1)),
    ("int ellipsis none", (1, Ellipsis, None)),
    ("empty slice", slice(5, 2)),
    ("reversed dims", (slice(7, 1, -3), slice(None), slice(None, None, -1))),
    ("int array", np.array([3, -1, 0])),
    ("int array dim 1", (slice(None), np.array([4, 0, -2]))),
    ("paired arrays", (np.array([1, 2, 8]), np.array([0, 4, 5]))),
    ("separated arrays", (np.array([0, 8]), slice(None), np.array([1, 2]))),
    ("2-d int array", np.array([[0, 1], [7, 3]])),
    ("int and array", (2, [0, 1])),
    ("list keys", ([0, 2], slice(None), [1, 0])),
    ("array after reversed slice", (slice(None, None, -1), [1, 0])),
    ("row mask", M0),
    ("full mask", X > 0),
    ("mask and slice", (M0, slice(1, 3))),
    ("mask dim 1", (slice(None), M1)),
    ("mask dim 1 and int", (slice(2, 8), M1, 3)),
    ("scalar true", True),
]


def _value_of(region_shape, kind, dtype=np.float32, seed=3):
    size = int(np.prod(region_shape))
    v = np.arange(size, dtype=np.float64).reshape(region_shape) - size / 2
    if kind == "scalar":
        return -7
    if kind == "row":  # broadcast along every dimension but the last
        v = v.reshape(-1)[: region_shape[-1]] if region_shape else v
    if dtype == np.bool_:
        return (v.astype(np.int64) % 3) == 0
    return v.astype(dtype)


def _check(ht, n, split, key, value, dtype=np.float32, x=None):
    x = _x(dtype=dtype) if x is None else x
    jc, tc = _pair(ht, n)
    a = ht.array(x, split=split, comm=jc)
    b = htt.array(x, split=split, comm=tc, device="cpu")
    a[key] = value
    b[key] = value
    _same(a, b)
    return b


@pytest.mark.parametrize("n, split, kind", [(n, s, k) for n in MESHES for s in (None, 0, 1) for k in ("scalar", "full")]
                         + [(4, s, "row") for s in (None, 0, 1)])
def test_every_key_form(ht, n, split, kind):
    for name, key in KEYS:
        region = X[key].shape
        if kind == "row" and not np.prod(region):
            continue
        _check(ht, n, split, key, _value_of(region, kind))


@pytest.mark.parametrize("n, split", [(1, 0), (8, 0), (4, None), (4, 0), (4, 1)])
def test_tensor_values_and_dndarray_keys(ht, n, split):
    jc, tc = _pair(ht, n)
    for name, key in [("slice", slice(1, 8)), ("int array", np.array([5, 0, -3])), ("row mask", M0)]:
        region = X[key].shape
        v = _value_of(region, "full")
        a = ht.array(X, split=split, comm=jc)
        b = htt.array(X, split=split, comm=tc, device="cpu")
        a[key] = v
        b[key] = torch.from_numpy(v)
        _same(a, b)
    # DNDarray keys: a split boolean mask (its shards are read as they lie)
    # and an integer index array
    for key, ksplit in [(M0, 0), (M0, None), (np.array([8, 1, 1, 4]), 0), (X > 0.5, split)]:
        a = ht.array(X, split=split, comm=jc)
        b = htt.array(X, split=split, comm=tc, device="cpu")
        a[ht.array(key, split=ksplit, comm=jc)] = 2.5
        b[htt.array(key, split=ksplit, comm=tc, device="cpu")] = 2.5
        _same(a, b)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("vsplit", [None, 0, 1, 2])
def test_dndarray_values_in_every_layout(ht, split, vsplit):
    """A DNDarray value split along the region's split dimension, along
    another one (resplit first), or replicated, at mesh 4."""
    jc, tc = _pair(ht, 4)
    for name, key in [("slice", slice(1, 8)), ("strided region", (slice(2, 9), slice(1, 5))),
                      ("negative step", slice(8, 0, -2)), ("row mask", M0), ("int array", np.array([7, 0, 3, 3 - 9])),
                      ("mask dim 1", (slice(None), M1)), ("full", slice(None))]:
        region = X[key].shape
        if vsplit is not None and vsplit >= len(region):
            continue
        v = _value_of(region, "full")
        a = ht.array(X, split=split, comm=jc)
        b = htt.array(X, split=split, comm=tc, device="cpu")
        a[key] = ht.array(v, split=vsplit, comm=jc)
        vb = htt.array(v, split=vsplit, comm=tc, device="cpu")
        b[key] = vb
        _same(a, b)
        np.testing.assert_array_equal(vb.numpy(), v)  # the value is not written to


@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.uint8, np.bool_, np.float64, np.float16, np.complex64, np.int64])
def test_other_dtypes_and_casts(ht, dtype):
    for name, key in [("slice", slice(2, 7)), ("row mask", M0), ("int array", np.array([3, -1, 0]))]:
        _check(ht, 4, 0, key, _value_of(X[key].shape, "full", dtype), dtype=dtype)
    _check(ht, 4, 0, X > 0, 1, dtype=dtype)
    # a value of another type is cast to the array's (in range)
    _check(ht, 4, 0, slice(1, 4), np.full((3, 6, 4), 3, np.int64), dtype=dtype)
    if dtype != np.bool_:
        _check(ht, 4, 0, slice(1, 4), np.full((3, 6, 4), True), dtype=dtype)


def test_bfloat16(ht):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = _x().astype(ml_dtypes.bfloat16)
    for key in (slice(2, 7), M0, np.array([3, -1, 0])):
        _check(ht, 4, 0, key, _value_of(X[key].shape, "full").astype(ml_dtypes.bfloat16), x=x)


@pytest.mark.parametrize("n", MESHES)
def test_out_of_bounds_and_duplicates(ht, n):
    import jax.numpy as jnp

    jc, tc = _pair(ht, n)
    for key in (9, -10, np.array([0, 9]), (slice(None), np.array([-7]))):
        b = htt.array(X, split=0, comm=tc, device="cpu")
        with pytest.raises(IndexError):
            ht.array(X, split=0, comm=jc)[key] = 1.0
        with pytest.raises(IndexError):
            b[key] = 1.0
    # device keys clamp into the extent
    rows = np.array([-20, 3, 40, -1])
    a = ht.array(X, split=0, comm=jc)
    b = htt.array(X, split=0, comm=tc, device="cpu")
    a[jnp.asarray(rows)] = 5.0
    b[torch.from_numpy(rows)] = 5.0
    _same(a, b)
    # duplicates: one of the written rows wins
    rows = np.array([4, 1, 4, 7, 1])
    v = np.arange(5 * 24, dtype=np.float32).reshape(5, 6, 4)
    for split in (None, 0, 1):
        b = htt.array(X, split=split, comm=tc, device="cpu")
        b[rows] = v
        got = b.numpy()
        for r in set(rows.tolist()):
            assert any(np.array_equal(got[r], v[i]) for i in np.nonzero(rows == r)[0])
        untouched = [r for r in range(9) if r not in rows]
        np.testing.assert_array_equal(got[untouched], X[untouched])


def test_scalar_bool_keys_and_errors(ht):
    b = htt.array(X, split=0, comm=htt.MeshComm(4), device="cpu")
    b[False] = 1.0
    np.testing.assert_array_equal(b.numpy(), X)
    with pytest.raises(ValueError):
        b[1:3] = np.ones((4, 6, 4), np.float32)
    with pytest.raises(IndexError):
        b[..., ...] = 0
    with pytest.raises(IndexError):
        b[X[:4] > 0] = 0
    with pytest.raises(TypeError):
        b[1.5] = 0


def test_writes_in_place_and_not_through_numpy(ht):
    b = htt.array(X, split=0, comm=htt.MeshComm(4), device="cpu")
    ptrs = [s.data_ptr() for s in b.shards]
    before = b.numpy()
    b[2:6] = 0.0
    b[M0] = 1.0
    b[[0, 8]] = 2.0
    assert [s.data_ptr() for s in b.shards] == ptrs
    np.testing.assert_array_equal(before, X)
    # a value that lies in the target's memory is read before it is written
    c = htt.array(X, split=0, comm=htt.MeshComm(4), device="cpu")
    c[1:9] = c[0:8]
    want = X.copy()
    want[1:9] = X[0:8]
    np.testing.assert_array_equal(c.numpy(), want)


def test_lloc_writes_through(ht):
    b = htt.array(X, split=1, comm=htt.MeshComm(4), device="cpu")
    b.lloc[1:3, 2] = 9.0
    want = X.copy()
    want[1:3, 2] = 9.0
    np.testing.assert_array_equal(b.numpy(), want)


# ------------------------------------------------------------------ K7 route
@pytest.mark.parametrize("S", [1, 3, 4, 8])
def test_rechunk_plan_at_explicit_bounds(S):
    rng = np.random.default_rng(S)
    for m, rowsz in [(37, 3), (1000, 1), (5, 7)]:
        cuts = np.sort(rng.integers(0, m + 1, S - 1))
        edges = [0] + cuts.tolist() + [m]
        bounds = list(zip(edges[:-1], edges[1:]))
        plan = transport.rechunk_plan(m, rowsz, m, rowsz, S, dst_bounds=bounds, max_shifts=None)
        src = np.arange(m * rowsz)
        per = -(-m // S)
        src_b = [(min(r * per, m) * rowsz, min((r + 1) * per, m) * rowsz) for r in range(S)]
        for d, (lo, hi) in enumerate(bounds):
            got = np.empty((hi - lo) * rowsz, np.int64)
            covered = 0
            for shift, so, do, ln in plan:
                r = (d - shift) % S
                if ln[r]:
                    got[do[r] : do[r] + ln[r]] = src[src_b[r][0] + so[r] : src_b[r][0] + so[r] + ln[r]]
                    covered += ln[r]
            assert covered == (hi - lo) * rowsz
            np.testing.assert_array_equal(got, src[lo * rowsz : hi * rowsz])
    # bounds need not tile the rows: one destination alone, or none
    plan = transport.rechunk_plan(10, 1, 10, 1, 2, dst_bounds=[(0, 0), (3, 8)], max_shifts=None)
    assert sum(sum(ln) for *_, ln in plan) == 5
    with pytest.raises(ValueError):
        transport.rechunk_plan(10, 1, 10, 1, 2, dst_bounds=[(0, 4), (5, 11)])


def test_rechunk_rows_into_shard_ranges_and_buffers():
    comm = htt.MeshComm(4)
    v = torch.arange(40 * 3, dtype=torch.float32).reshape(40, 3)
    shards = list(v.split(10))
    target = torch.zeros(60, 3)
    bounds = [(0, 2), (2, 2), (2, 31), (31, 40)]
    outs = [target[5:7], None, target[20:49], None]
    before = k7.calls
    got = transport.rechunk_rows(shards, bounds, comm, out=outs)
    assert k7.calls - before == 3  # one per destination with rows
    assert got[0] is outs[0] and got[1] is None and got[2] is outs[2]
    torch.testing.assert_close(target[5:7], v[0:2], rtol=0, atol=0)
    torch.testing.assert_close(target[20:49], v[2:31], rtol=0, atol=0)
    torch.testing.assert_close(got[3], v[31:40], rtol=0, atol=0)


def test_rechunk_rows_splits_wide_destinations():
    # a destination drawn from more source chunks than one launch takes
    comm = htt.MeshComm(12)
    v = torch.arange(120, dtype=torch.int32)
    shards = list(v.reshape(120, 1).split(10))
    bounds = [(0, 0)] * 11 + [(0, 120)]
    before = k7.calls
    got = transport.rechunk_rows(shards, bounds, comm)
    assert k7.calls - before == 2  # 12 segments: 8 + 4
    assert torch.equal(got[-1].reshape(-1), v)


def test_plain_repack_into_out():
    src = torch.arange(30, dtype=torch.int16)
    out = torch.full((12,), -1, dtype=torch.int16)
    got = k7.reference_repack_segments([(src, 3, 5), (src, 20, 7)], (12,), out=out)
    assert got is out
    assert torch.equal(out, torch.cat([src[3:8], src[20:27]]))


@pytest.mark.parametrize("n", [4, 8])
def test_routes_count_k7_calls(ht, n):
    """A value split along the region's rows goes through K7, one call per
    position whose shard receives rows: whole rows (into the shard),
    a column-restricted or stepped region (into a buffer), a row mask."""
    jc, tc = _pair(ht, n)
    x = _x((40, 6))
    starts = [tc.chunk((40, 6), 0, rank=r)[0] for r in range(n)]
    ends = starts[1:] + [40]
    for name, key in [("whole rows", slice(5, 26)), ("strided region", (slice(5, 26), slice(1, 4))),
                      ("stepped rows", slice(0, 40, 3)), ("row mask", x[:, 0] > 0)]:
        region = x[key].shape
        v = np.arange(np.prod(region), dtype=np.float32).reshape(region)
        a = ht.array(x, split=0, comm=jc)
        b = htt.array(x, split=0, comm=tc, device="cpu")
        a[key] = ht.array(v, split=0, comm=jc)
        vb = htt.array(v, split=0, comm=tc, device="cpu")
        before = k7.calls
        b[key] = vb
        calls = k7.calls - before
        _same(a, b)
        rows = np.arange(40)[key if isinstance(key, (slice, np.ndarray)) else key[0]]
        want = sum(1 for lo, hi in zip(starts, ends) if ((rows >= lo) & (rows < hi)).any())
        assert calls == want, (name, calls, want)
    # a value split along the columns is resplit to the rows first; a
    # replicated value is read where it lies, without K7
    y = _x((21, 6), seed=5)
    rows = np.arange(5, 26)
    want = sum(1 for lo, hi in zip(starts, ends) if ((rows >= lo) & (rows < hi)).any())
    for vsplit, calls in ((1, want), (None, 0)):
        b = htt.array(x, split=0, comm=tc, device="cpu")
        before = k7.calls
        b[5:26] = htt.array(y, split=vsplit, comm=tc, device="cpu")
        assert k7.calls - before == calls
        np.testing.assert_array_equal(b.numpy()[5:26], y)


# ----------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8])
def test_slice_route_launches_k7_into_shards_on_card(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(21)
    comm = htt.MeshComm(n)
    g = _card((1003, 37), gen, cuda)
    y = _card((500, 37), gen, cuda)
    x = htt.array(g.clone(), split=0, comm=comm)
    ptrs = [s.data_ptr() for s in x.shards]
    before = k7.launches
    x[301:801] = htt.array(y, split=0, comm=comm)
    torch.cuda.synchronize()
    want = g.clone()
    want[301:801] = y
    assert torch.equal(x.larray, want)
    assert [s.data_ptr() for s in x.shards] == ptrs
    lo = [comm.chunk((1003, 37), 0, rank=r)[0] for r in range(n)]
    hi = lo[1:] + [1003]
    expect = sum(1 for r in range(n) if max(lo[r], 301) < min(hi[r], 801))
    assert k7.launches - before == expect


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.float64, torch.bfloat16])
def test_strided_and_mask_routes_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(22)
    comm = htt.MeshComm(4)
    g = _card((2001, 9), gen, cuda).to(dtype)
    x = htt.array(g.clone(), split=0, comm=comm)
    want = g.clone()
    # a region that restricts columns: K7 into a buffer, one copy_ places it
    v = _card((1000, 5), gen, cuda).to(dtype)
    before = k7.launches
    x[7:1007, 2:7] = htt.array(v, split=0, comm=comm)
    want[7:1007, 2:7] = v
    torch.cuda.synchronize()
    assert torch.equal(x.larray, want) and k7.launches - before == 3  # rows 7..1006 cross positions 0, 1, 2
    # a row mask: each position's selected rows from the value's chunks
    mask = torch.rand(2001, generator=gen, device=cuda) < 0.4
    w = _card((int(mask.sum()), 9), gen, cuda).to(dtype)
    before = k7.launches
    x[htt.array(mask, split=0, comm=comm)] = htt.array(w, split=0, comm=comm)
    want[mask] = w
    torch.cuda.synchronize()
    assert torch.equal(x.larray, want) and k7.launches - before == 4
    # an integer put and a full mask of a scalar take no kernel
    rows = torch.randperm(2001, generator=gen, device=cuda)[:300]
    u = _card((300, 9), gen, cuda).to(dtype)
    x[rows] = htt.array(u, split=0, comm=comm)
    want[rows] = u
    full = _card((2001, 9), gen, cuda) > 1
    x[htt.array(full, split=0, comm=comm)] = 0
    want[full] = 0
    torch.cuda.synchronize()
    assert torch.equal(x.larray, want)


@pytest.mark.gpu
def test_repack_into_out_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(23)
    src = torch.randint(-100, 100, (4099,), generator=gen, device=cuda, dtype=torch.int8)
    for at in (0, 1, 3, 16, 17):
        out = torch.zeros(4200, dtype=torch.int8, device=cuda)
        k7.repack_segments([(src, 5, 1000), (src, 2000, 999)], (1999,), out=out.narrow(0, at, 1999))
        torch.cuda.synchronize()
        assert torch.equal(out[at : at + 1999], torch.cat([src[5:1005], src[2000:2999]]))
        assert not out[:at].any() and not out[at + 1999 :].any()
