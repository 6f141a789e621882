"""Parity of heat_tpu_torch's transport engine with heat_tpu's on the CPU
(mirrors tests/test_transport.py).

The host plans (``rechunk_plan``, ``resplit_applicable``,
``reshape_applicable``) must equal the JAX package's.  ``tiled_resplit``,
``tiled_reshape`` and the public ``reshape``/``resplit``/``resplit_`` must
give the same global values and the same per-position shards as heat_tpu on
the conftest mesh cut to 1, 4 and 8 positions, and as numpy's chunk rule,
bitwise: transport is pure data movement, so the tolerance is zero.  Every
split-crossing reshape calls K7's wrapper once per destination position
with rows (``ops.repack.calls``), the split-preserving one never."""

import itertools

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import repack
from heat_tpu_torch.parallel import transport

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def jt(ht):
    from heat_tpu.parallel import transport as jt

    return jt


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _same_bits(x: np.ndarray, y: np.ndarray):
    assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, x.dtype, y.shape, y.dtype)
    np.testing.assert_array_equal(_bits(x), _bits(y))


def _chunks(x: np.ndarray, split, n):
    """numpy's cut of ``x`` by the chunk rule: even ceil chunks, trailing
    ones truncated."""
    if split is None:
        return [x]
    per = -(-x.shape[split] // n) if x.shape[split] else 0
    return [np.take(x, np.arange(min(r * per, x.shape[split]), min((r + 1) * per, x.shape[split])), axis=split)
            for r in range(n)]


def _same(a, b, want: np.ndarray):
    """heat_tpu's ``a`` and the port's ``b`` against numpy's ``want``, in
    values, shape, dtype, split and per-position shards, bitwise."""
    assert tuple(a.shape) == tuple(b.shape) == want.shape
    assert a.split == b.split
    _same_bits(b.numpy(), want)
    _same_bits(a.numpy(), want)
    sa, sb = a.lshards(), b.lshards()
    sw = _chunks(want, b.split, b.comm.size)
    assert len(sa) == len(sb) == len(sw)
    for x, y, w in zip(sa, sb, sw):
        _same_bits(np.asarray(x), w)
        _same_bits(y, w)


PLAN_CASES = [
    (1000, 10, 100, 100), (37, 15, 555, 1), (96, 7, 42, 16), (8, 3, 24, 1), (1000, 10, 10000, 1),
    (6, 4, 24, 1), (6, 40, 24, 10), (13, 3, 39, 1), (60, 1, 3, 20), (10, 3, 7, 4), (0, 1, 0, 1),
    (999, 20, 1998, 10), (5, 7, 7, 5), (64, 10, 8, 80), (1, 12, 12, 1),
]


@pytest.mark.parametrize("S", (1, 4, 8))
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_rechunk_plan_equals_jax(jt, case, S):
    got = transport.rechunk_plan(*case, S)
    assert got == jt.rechunk_plan(*case, S)
    if got is not None:
        # every element of the stream moves exactly once
        assert sum(sum(e[3]) for e in got) == case[0] * case[1]


def test_rechunk_plan_refuses_shift_heavy_stream():
    # 60 elements into 3 rows over 8 positions concentrate the stream on
    # three destinations: more than four distinct shifts
    assert transport.rechunk_plan(60, 1, 3, 20, 8) is None
    assert transport._MAX_SHIFTS == 4


APPLICABLE = [
    ((1000, 10), 0, (100, 100), 1), ((1000, 10), 1, (10000,), 0), ((37, 15), 0, (555,), 0),
    ((96, 7), 1, (42, 16), 0), ((64, 10), 0, (8, 8, 10), 2), ((128, 4), 0, (128, 2, 2), 0),
    ((60,), 0, (3, 4, 5), 1), ((24,), None, (4, 6), None), ((6, 4), 0, (24,), None),
    ((0, 4), 0, (4, 0), 0), ((6, 4), 1, (2, 12), 1), ((13, 3), 0, (39,), 0),
]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", APPLICABLE, ids=str)
def test_reshape_applicable_equals_jax(ht, jt, case, n):
    jc, tc = _pair(ht, n)
    assert transport.reshape_applicable(*case[:4], tc) == jt.reshape_applicable(*case[:4], jc)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize(
    "gshape,sa,sb",
    [((5, 7), 0, 1), ((5, 7), 1, 0), ((5, 7), None, 0), ((5, 7), 0, None), ((5, 7), 0, 0),
     ((7,), 0, 0), ((0, 7), 0, 1), ((3, 4, 5), 2, 0)],
    ids=str,
)
def test_resplit_applicable_equals_jax(ht, jt, gshape, sa, sb, n):
    jc, tc = _pair(ht, n)
    assert transport.resplit_applicable(gshape, sa, sb, tc) == jt.resplit_applicable(gshape, sa, sb, jc)


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1000, 1000, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


RESPLIT_SHAPES = [(13, 6), (6, 13), (5, 3, 7), (9, 1, 4)]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("shape", RESPLIT_SHAPES, ids=str)
def test_tiled_resplit_all_axis_pairs(ht, n, shape):
    jc, tc = _pair(ht, n)
    x = _data(shape, np.float32)
    for sa, sb in itertools.permutations(range(len(shape)), 2):
        b = htt.array(x, split=sa, comm=tc, device="cpu")
        shards = transport.tiled_resplit(b.shards, shape, sa, sb, tc)
        got = htt.DNDarray(shards, shape, b.dtype, sb, b.device, tc)
        a = ht.array(x, split=sa, comm=jc).resplit(sb)
        _same(a, got, x)
        # the source's shards are untouched
        _same_bits(b.numpy(), x)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_, np.float64, np.int8], ids=lambda d: np.dtype(d).name)
def test_resplit_inplace_and_outofplace(ht, n, dtype):
    jc, tc = _pair(ht, n)
    x = _data((33, 14), dtype, seed=1)
    for sa, sb in [(0, 1), (1, 0), (0, None), (None, 1)]:
        b = htt.array(x, split=sa, comm=tc, device="cpu")
        c = htt.resplit(b, sb)
        a = ht.resplit(ht.array(x, split=sa, comm=jc), sb)
        _same(a, c, x)
        assert b.split == sa
        _same_bits(b.numpy(), x)
        assert b.resplit_(sb) is b
        _same(a, b, x)
    # a 0→1→None→0 round trip
    b = htt.array(x, split=0, comm=tc, device="cpu")
    for axis in (1, None, 0):
        b.resplit_(axis)
        assert b.split == axis
    _same(ht.array(x, split=0, comm=jc), b, x)


# (input shape, input split, output shape, output split): pad-carrying
# (rows that do not divide), shift-carrying (an empty source position),
# split-crossing both ways, split-preserving, and 3-D
RESHAPE_CASES = [
    ((999, 20), 0, (1998, 10), 0),
    ((1000, 10), 0, (100, 100), 1),
    ((1000, 10), 1, (10000,), 0),
    ((37, 15), 0, (555,), 0),
    ((96, 7), 1, (42, 16), 0),
    ((64, 10), 0, (8, 8, 10), 2),
    ((6, 40), 0, (24, 10), 0),
    ((6, 40), 1, (24, 10), 1),
    ((13, 3), 0, (3, 13), 0),
    ((40, 30), 1, (120, 10), 1),
    ((128, 4), 0, (128, 2, 2), 0),
    ((6, 4, 5), 0, (6, 20), 0),
    ((5, 12), 1, (5, 3, 4), 1),
]


def _k7_calls(gout, so, n):
    """Destination positions with rows in the rechunk's split-0 layout."""
    return sum(1 for r in range(n) if htt.MeshComm(n).chunk(gout, 0, rank=r)[1][0] > 0)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", RESHAPE_CASES, ids=str)
def test_tiled_reshape_matches_heat_tpu(ht, jt, case, n):
    shp, si, gout, so = case
    jc, tc = _pair(ht, n)
    x = _data(shp, np.float32, seed=2)
    want = x.reshape(gout)
    b = htt.array(x, split=si, comm=tc, device="cpu")
    applicable = transport.reshape_applicable(shp, si, gout, so, tc)
    assert applicable == jt.reshape_applicable(shp, si, gout, so, jc)
    preserving = transport._prefix_prod(shp, si) == transport._prefix_prod(gout, so) and shp[si] == gout[so]
    before = repack.calls
    got = htt.reshape(b, gout, new_split=so)
    calls = repack.calls - before
    if applicable and not preserving:
        assert calls == _k7_calls(gout, so, n)
    else:
        assert calls == 0
    a = ht.reshape(ht.array(x, split=si, comm=jc), gout, new_split=so)
    _same(a, got, want)
    _same_bits(b.numpy(), x)


@pytest.mark.parametrize("n", (4, 8))
def test_tiled_reshape_direct_and_the_empty_destination(n):
    # (6, 40) → (24, 10) over 4 positions: the plan has shifts {0, 1} and
    # no source rows at position 3; over 8 the rows spread wider
    tc = htt.MeshComm(n)
    x = _data((6, 40), np.float32, seed=3)
    b = htt.array(x, split=0, comm=tc, device="cpu")
    plan = transport.rechunk_plan(6, 40, 24, 10, n)
    if n == 4:
        assert [e[0] for e in plan] == [0, 1]
        assert [s.shape[0] for s in b.shards] == [2, 2, 2, 0]
    before = repack.calls
    shards = transport.tiled_reshape(b.shards, (6, 40), 0, (24, 10), 0, tc)
    assert repack.calls - before == _k7_calls((24, 10), 0, n)
    for got, w in zip(shards, _chunks(x.reshape(24, 10), 0, n)):
        _same_bits(got.numpy(), w)
        assert got.is_contiguous()


@pytest.mark.parametrize("n", (4, 8))
def test_reshape_with_an_empty_destination_launches_nothing_there(n):
    # 6 rows over 8 positions: positions 6 and 7 get none
    tc = htt.MeshComm(n)
    x = _data((3, 4), np.float32, seed=4)
    b = htt.array(x, split=0, comm=tc, device="cpu")
    before = repack.calls
    got = htt.reshape(b, (6, 2))
    assert repack.calls - before == _k7_calls((6, 2), 0, n)
    assert [s.shape[0] for s in got.shards] == [int(m[0]) for m in tc.lshape_map((6, 2), 0)]
    _same_bits(got.numpy(), x.reshape(6, 2))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize(
    "dtype", [np.bool_, np.int8, np.float16, np.float64, np.int64, np.complex64], ids=lambda d: np.dtype(d).name
)
def test_reshape_dtypes_bitwise(ht, n, dtype):
    jc, tc = _pair(ht, n)
    x = _data((30, 14), dtype, seed=5)
    if dtype == np.complex64:
        x = (x + 1j * _data((30, 14), np.float32, seed=6)).astype(np.complex64)
    a = ht.reshape(ht.array(x, split=0, comm=jc), (60, 7))
    b = htt.reshape(htt.array(x, split=0, comm=tc, device="cpu"), (60, 7))
    _same(a, b, x.reshape(60, 7))


def test_bfloat16_reshape_is_exact():
    x = torch.randn(30, 14, generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    b = htt.reshape(htt.array(x, split=1, comm=htt.MeshComm(4), device="cpu"), (60, 7), new_split=1)
    assert torch.equal(b.larray.view(torch.int16), x.reshape(60, 7).view(torch.int16))


@pytest.mark.parametrize("n", (4, 8))
def test_shift_heavy_shape_routes_as_in_heat_tpu(ht, jt, n):
    # m_out < S concentrates the stream on a few positions: over 8 the plan
    # exceeds the shift budget in both packages, and both gather; over 4 it
    # fits, and both run the engine
    jc, tc = _pair(ht, n)
    shp, gout = (60,), (3, 4, 5)
    applicable = transport.reshape_applicable(shp, 0, gout, 1, tc)
    assert applicable == jt.reshape_applicable(shp, 0, gout, 1, jc)
    assert applicable == (n == 4)
    x = np.arange(60, dtype=np.float32)
    before = repack.calls
    b = htt.reshape(htt.array(x, split=0, comm=tc, device="cpu"), gout, new_split=1)
    assert repack.calls - before == (_k7_calls(gout, 1, n) if applicable else 0)
    _same(ht.reshape(ht.array(x, split=0, comm=jc), gout, new_split=1), b, x.reshape(gout))


@pytest.mark.parametrize("n", MESHES)
def test_replicated_reshape_keeps_the_gathered_route(ht, n):
    jc, tc = _pair(ht, n)
    x = np.arange(24, dtype=np.float32)
    before = repack.calls
    b = htt.reshape(htt.array(x, comm=tc, device="cpu"), (4, 6))
    assert repack.calls == before
    _same(ht.reshape(ht.array(x, comm=jc), (4, 6)), b, x.reshape(4, 6))


def test_strided_split0_shards_are_made_contiguous_explicitly():
    # shards that are column views of a wider array
    tc = htt.MeshComm(4)
    base = torch.arange(13 * 8, dtype=torch.float32).reshape(13, 8)
    src = htt.array(base, split=0, comm=tc, device="cpu")
    view = src[:, ::2]
    assert not all(s.is_contiguous() for s in view.shards if s.numel())
    got = htt.reshape(view, (26, 2))
    assert torch.equal(got.larray, base[:, ::2].reshape(26, 2))


def test_tiled_take_matches_numpy():
    tc = htt.MeshComm(4)
    x = _data((13, 3), np.float32, seed=8)
    b = htt.array(x, split=0, comm=tc, device="cpu")
    rows = np.array([12, 0, 5, 5, 7, 3, 11, 1, 0, 9, 2], np.int64)
    shards = transport.tiled_take(b.shards, torch.from_numpy(rows), 13, 0, tc)
    for got, w in zip(shards, _chunks(x[rows], 0, 4)):
        _same_bits(got.numpy(), w)
    b1 = htt.array(x, split=1, comm=tc, device="cpu")
    cols = np.array([2, 0, 1, 2])
    shards = transport.tiled_take(b1.shards, torch.from_numpy(cols), 3, 1, tc)
    for got, w in zip(shards, _chunks(x[:, cols], 1, 4)):
        _same_bits(got.numpy(), w)


TAKE_ROWS = {
    # sorted rows: each destination chunk has one owner
    "sorted": lambda rng, n: np.arange(n, dtype=np.int64),
    # a random order with repeats: chunks draw on several owners
    "random": lambda rng, n: rng.integers(0, n, size=2 * n + 1),
    # every row from the last non-empty source chunk
    "last": lambda rng, n: np.full(5, n - 1, np.int64),
}


@pytest.mark.parametrize("case", sorted(TAKE_ROWS))
@pytest.mark.parametrize("rows_n", [6, 29])
@pytest.mark.parametrize("n", MESHES)
def test_tiled_take_owner_routes(n, rows_n, case):
    # 6 rows over 8 positions leaves trailing source chunks empty
    tc = htt.MeshComm(n)
    rng = np.random.default_rng(rows_n)
    x = _data((rows_n, 3), np.float32, seed=11)
    rows = TAKE_ROWS[case](rng, rows_n)
    for split, xs in ((0, x), (1, np.ascontiguousarray(x.T))):
        b = htt.array(xs, split=split, comm=tc, device="cpu")
        shards = transport.tiled_take(b.shards, torch.from_numpy(rows), rows_n, split, tc)
        want = np.take(xs, rows, axis=split)
        for got, w in zip(shards, _chunks(want, split, n)):
            _same_bits(got.numpy(), w)


@pytest.mark.parametrize("n", MESHES)
def test_ppermute_and_exscan_match_numpy(n):
    from heat_tpu_torch.parallel import collectives

    rng = np.random.default_rng(9)
    blocks = [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(n)]
    parts = [torch.from_numpy(b) for b in blocks]
    # a permutation that leaves position 0 without a sender when n > 1
    perm = [(i, i + 1) for i in range(n - 1)]
    got = collectives.ppermute(parts, perm)
    for j in range(n):
        want = blocks[j - 1] if j > 0 else np.zeros((3, 2), np.float32)
        np.testing.assert_array_equal(got[j].numpy(), want)
    got = collectives.exscan(parts)
    for j in range(n):
        want = np.zeros((3, 2), np.float32)
        for b in blocks[:j]:
            want = want + b
        np.testing.assert_array_equal(got[j].numpy(), want)
    with pytest.raises(ValueError):
        collectives.ppermute(parts, [(0, 0), (0, 0)])
    with pytest.raises(ValueError):
        collectives.ppermute(parts, [(0, n)])
