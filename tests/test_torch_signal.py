"""Halos, ``convolve``, every ``pad`` mode, the tile classes and
``mpi_topk``: heat_tpu_torch against heat_tpu on the CPU at meshes 1, 4 and
8, and ``convolve`` on the card against the CPU.

Halos, pads and tiles move values without arithmetic and must agree
bitwise, ``linear_ramp`` too (its step is ``i · (1/num)`` as XLA folds
it); ``mean`` and ``median`` sum or interpolate, so float32 to 2 ulps of
the value or 4 ulps of max|x|, whichever is larger (integers bitwise).
``convolve`` sums in another order than XLA's convolution: float32 to
1e-5·Σ|v|·max|a|, float64 to 1e-12 of that, integers exactly.  13 rows
over 8 positions leave shards of 2, 2, 2, 2, 2, 2, 1 and 0 rows.
"""

import importlib

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import halo

signal_mod = importlib.import_module("heat_tpu_torch.core.signal")


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


MESHES = (1, 4, 8)


def _rand(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _arrays(ht, n, x, split):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    return ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")


def _np(t):
    return None if t is None else np.asarray(t)


def _bitwise(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


# ----------------------------------------------------------------- halos
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (0, 1))
def test_get_halo_and_the_halo_members(ht, n, split):
    x = _rand(13, 6, seed=1) if split == 0 else _rand(5, 13, seed=1)
    ja, ta = _arrays(ht, n, x, split)
    for size in (0, 1, 2):
        try:
            ja.get_halo(size)
        except ValueError:
            # a populated shard shorter than the halo: both refuse it
            with pytest.raises(ValueError, match="smaller than chunk-size"):
                ta.get_halo(size)
            continue
        ta.get_halo(size)
        for r in range(n):
            jp, jn = ja.shard_halos(r)
            tp, tn = ta.shard_halos(r)
            _bitwise(_np(jp), None if tp is None else tp.numpy())
            _bitwise(_np(jn), None if tn is None else tn.numpy())
            _bitwise(np.asarray(ja.shard_with_halos(r)), ta.shard_with_halos(r).numpy())
        _bitwise(_np(ja.halo_prev), None if ta.halo_prev is None else ta.halo_prev.numpy())
        _bitwise(_np(ja.halo_next), None if ta.halo_next is None else ta.halo_next.numpy())
        _bitwise(np.asarray(ja.array_with_halos), ta.array_with_halos.numpy())
    # a write drops them
    ta.get_halo(1)
    ta[0] = 5.0
    assert ta.shard_halos(1) == (None, None) and ta.halo_next is None
    with pytest.raises(TypeError):
        ta.get_halo(1.0)
    with pytest.raises(ValueError):
        ta.get_halo(-1)


def test_replicated_halos_and_exchange():
    a = htt.array(_rand(6, 2), device="cpu", comm=htt.MeshComm(4))
    a.get_halo(2)
    assert a.halo_prev is None and a.halo_next is None and a.array_with_halos is a.shards[0]
    blocks = [torch.arange(3.0) + 10 * r for r in range(3)]
    prev, nxt = halo.halo_exchange(blocks, 1)
    assert [p.tolist() for p in prev] == [[0.0], [2.0], [12.0]] and [q.tolist() for q in nxt] == [[10.0], [20.0], [0.0]]
    prev, nxt = halo.halo_exchange(blocks, 2, wrap=True)
    assert [p.tolist() for p in prev] == [[21.0, 22.0], [1.0, 2.0], [11.0, 12.0]]
    assert nxt[2].tolist() == [0.0, 1.0]
    with pytest.raises(ValueError):
        halo.halo_exchange(blocks, 4)


@pytest.mark.parametrize("n, wrap", [(1, False), (4, False), (8, False), (4, True)])
def test_map_with_halos(ht, n, wrap):
    from heat_tpu.ops import halo as jhalo

    x = _rand(16, 3, seed=2)
    ja, ta = _arrays(ht, n, x, 0)

    def stencil(t, edge):
        return t[:-2] + 2 * t[1:-1] + t[2:] + edge.sum()

    want = jhalo.map_with_halos(stencil, ja, 1, wrap=wrap)
    got = halo.map_with_halos(stencil, ta, 1, wrap=wrap)
    assert got.split == want.split == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want.larray), rtol=1e-6)
    jr, tr = _arrays(ht, n, x, None)
    np.testing.assert_allclose(halo.map_with_halos(stencil, tr, 1).numpy(),
                               np.asarray(jhalo.map_with_halos(stencil, jr, 1).larray), rtol=1e-6)


# -------------------------------------------------------------- convolve
@pytest.mark.parametrize("n, split", [(1, 0), (4, 0), (8, 0), (4, None)])
@pytest.mark.parametrize("k", (4, 5, 30))
def test_convolve(ht, n, split, k):
    a = _rand(23, seed=3)
    v = _rand(k, seed=4)
    ja, ta = _arrays(ht, n, a, split)
    tol = 1e-5 * np.abs(v).sum() * np.abs(a).max()
    for mode in ("full", "same", "valid"):
        if mode == "valid" and k > 23:
            continue
        want, got = ht.convolve(ja, v, mode=mode), htt.convolve(ta, v, mode=mode)
        assert got.shape == want.shape and got.split == want.split and got.dtype is htt.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want.larray), rtol=0, atol=tol)
        if split is not None:
            assert [s.shape for s in got.lshards()] == [s.shape for s in want.lshards()]
        if k <= 23:
            # numpy centres "same" on the longer input; the JAX package keeps
            # a's length (reference fault (g))
            np.testing.assert_allclose(got.numpy(), np.convolve(a, v, mode=mode), rtol=0, atol=tol)
    if k != 4:
        return
    ai = np.arange(23, dtype=np.int32) - 7
    ji, ti = _arrays(ht, n, ai, split)
    vi = htt.array(np.array([1, -2, 3, 1], np.int32), device="cpu")
    for mode in ("full", "same", "valid"):
        want, got = ht.convolve(ji, np.array([1, -2, 3, 1], np.int32), mode=mode), htt.convolve(ti, vi, mode=mode)
        assert got.dtype is htt.int32
        _bitwise(np.asarray(want.larray), got.numpy())


@pytest.mark.parametrize("n", MESHES)
def test_convolve_valid_with_a_longer_filter_is_empty(ht, n):
    """F9: ``valid`` with a filter longer than ``a`` gives heat_tpu's empty
    array, split as ``a`` (numpy would swap the inputs: reference fault
    (g)), in the promoted type."""
    for a, v in ((np.arange(1, 6, dtype=np.float32), np.arange(1, 10, dtype=np.float32)),
                 (np.arange(1, 6), np.arange(1, 10))):
        for split in (0, None):
            ja, ta = _arrays(ht, n, a, split)
            want, got = ht.convolve(ja, v, mode="valid"), htt.convolve(ta, v, mode="valid")
            assert got.shape == want.shape == (0,) and got.split == want.split == split
            assert got.dtype.__name__ == want.dtype.__name__
            assert [s.shape for s in got.lshards()] == [(0,)] * (n if split is not None else 1)


def test_convolve_float64_halo_bytes_and_errors(ht):
    a, v = _rand(40, seed=5, dtype=np.float64), _rand(7, seed=6, dtype=np.float64)
    ja, ta = _arrays(ht, 4, a, 0)
    np.testing.assert_allclose(htt.convolve(ta, v, mode="same").numpy(), np.asarray(ht.convolve(ja, v, mode="same").larray),
                               rtol=0, atol=1e-12 * np.abs(v).sum() * np.abs(a).max())
    # full: outputs [0,12), [12,24), [24,36), [36,46) read a[-6..11], a[6..23],
    # a[18..35] and a[30..39] (shards of 10 rows): 2 + 8 + 8 + 0 rows from
    # other positions
    htt.convolve(ta, v, mode="full")
    assert signal_mod.last_halo_bytes == (2 + 8 + 8 + 0) * 8
    with pytest.raises(ValueError):
        htt.convolve(ta, v, mode="nope")
    with pytest.raises(ValueError):
        htt.convolve(htt.array(_rand(3, 3), device="cpu"), v)


# ------------------------------------------------------------------- pad
MODES = ("constant", "edge", "wrap", "reflect", "symmetric", "maximum", "minimum", "empty", "mean", "median",
         "linear_ramp")
WIDTHS = (((3, 30), (2, 1)), ((0, 0), (7, 12)), 2)


@pytest.mark.parametrize("dtype", (np.float32, np.int32))
@pytest.mark.parametrize("mode", MODES)
def test_pad_every_mode(ht, dtype, mode):
    """``jnp.pad`` of the global array gives the values (heat_tpu at one
    position); the port pads at every mesh and split, the split axis
    included, and its shards follow the chunk rule as heat_tpu's do."""
    x = (_rand(13, 5, seed=7) * 10).astype(dtype)
    jx = ht.array(x, comm=ht.parallel.mesh.local_mesh(1))
    for pw in WIDTHS:
        w = np.asarray(ht.pad(jx, pw, mode=mode).larray)
        for n in MESHES:
            for split in (None, 0, 1):
                got = htt.pad(htt.array(x, split=split, comm=htt.MeshComm(n), device="cpu"), pw, mode=mode)
                assert got.shape == w.shape and got.split == split, (mode, pw)
                g = got.numpy()
                if mode in ("mean", "median") and dtype == np.float32:
                    atol = 4 * np.finfo(np.float32).eps * np.abs(x).max()
                    np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=atol, err_msg=f"{mode} {pw}")
                else:
                    _bitwise(w, g)
    ja, ta = _arrays(ht, 4, x, 0)
    want, got = ht.pad(ja, WIDTHS[0], mode=mode), htt.pad(ta, WIDTHS[0], mode=mode)
    assert [s.shape for s in got.lshards()] == [s.shape for s in want.lshards()]


@pytest.mark.parametrize("n", (1, 4))
def test_pad_constants_callables_and_errors(ht, n):
    x = _rand(13, 5, seed=8)
    ja, ta = _arrays(ht, n, x, 0)
    for cv in (2.5, (1, 2), ((1, 2), (3, 4))):
        _bitwise(np.asarray(ht.pad(ja, ((2, 3), (1, 1)), constant_values=cv).larray),
                 htt.pad(ta, ((2, 3), (1, 1)), constant_values=cv).numpy())
    # one element wide: reflect repeats it
    j1, t1 = _arrays(ht, n, x[:1], 0)
    _bitwise(np.asarray(ht.pad(j1, ((4, 2), (0, 0)), mode="reflect").larray),
             htt.pad(t1, ((4, 2), (0, 0)), mode="reflect").numpy())

    def ends(row, width, axis, kwargs):
        row = row.copy() if isinstance(row, np.ndarray) else row.clone() if isinstance(row, torch.Tensor) else row
        if isinstance(row, torch.Tensor):
            row[: width[0]] = -1
            return row
        return row.at[: width[0]].set(-1)

    _bitwise(np.asarray(ht.pad(ja, 1, mode=ends).larray), htt.pad(ta, 1, mode=ends).numpy())
    with pytest.raises(ValueError):
        htt.pad(ta, -1)
    with pytest.raises(NotImplementedError):
        htt.pad(ta, 1, mode="bogus")
    je, te = _arrays(ht, n, np.zeros((0, 3), np.float32), None)
    with pytest.raises(ValueError):
        htt.pad(te, 1, mode="edge")


# ----------------------------------------------------------------- tiles
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (None, 0, 1))
def test_split_tiles(ht, n, split):
    x = _rand(13, 6, seed=9)
    ja, ta = _arrays(ht, n, x, split)
    jt, tt = ht.SplitTiles(ja), htt.SplitTiles(ta)
    assert [d.tolist() for d in tt.tile_dimensions] == [d.tolist() for d in jt.tile_dimensions]
    _bitwise(jt.tile_locations, tt.tile_locations)
    for r in range(n):
        assert tt.tile_ranges(r) == jt.tile_ranges(r)
        _bitwise(np.asarray(jt[r]), tt[r].numpy())
    assert tt.arr is ta


@pytest.mark.parametrize("n", MESHES)
def test_split_tiles_off_the_mesh(ht, n):
    """F11: a rank at or past the mesh size, or a negative one, reads an
    empty tile, as heat_tpu's chunk slice gives it; a slice key raises
    ``TypeError`` in both."""
    x = _rand(7, 13, seed=12)
    for split in (0, 1):
        ja, ta = _arrays(ht, n, x, split)
        jt, tt = ht.SplitTiles(ja), htt.SplitTiles(ta)
        for r in (n, n + 3, -1, -n):
            _bitwise(np.asarray(jt[r]), tt[r].numpy())
        with pytest.raises(TypeError):
            jt[0:1]
        with pytest.raises(TypeError):
            tt[0:1]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (0, 1))
@pytest.mark.parametrize("shape, per", [((13, 13), 2), ((20, 9), 3)])
def test_square_diag_tiles(ht, n, split, shape, per):
    x = _rand(*shape, seed=10)
    ja, ta = _arrays(ht, n, x, split)
    jt, tt = ht.SquareDiagTiles(ja, per), htt.SquareDiagTiles(ta, per)
    for name in ("row_indices", "col_indices", "tile_rows", "tile_columns", "last_diagonal_process",
                 "tile_rows_per_process", "tile_columns_per_process", "tiles_per_proc"):
        assert getattr(tt, name) == getattr(jt, name), name
    _bitwise(jt.tile_map, tt.tile_map)
    for i in range(tt.tile_rows):
        for j in range(tt.tile_columns):
            assert tt.get_start_stop((i, j)) == jt.get_start_stop((i, j))
            _bitwise(np.asarray(jt[i, j]), tt[i, j].numpy())
        _bitwise(np.asarray(jt[i]), tt[i].numpy())
    _bitwise(np.asarray(jt[0:2, -1]), tt[0:2, -1].numpy())
    _bitwise(np.asarray(jt.local_get((0, 0))), tt.local_get((0, 0)).numpy())
    value = np.full(tuple(np.asarray(jt[-1, 0]).shape), 7.0, np.float32)
    jt[-1, 0] = value
    tt[-1, 0] = torch.from_numpy(value)
    jt.local_set((0, -1), 3.0)
    tt.local_set((0, -1), 3.0)
    _bitwise(np.asarray(ja.larray), ta.numpy())
    # Q's grid matched to R's (the tiled QR's use)
    jo, to = _arrays(ht, n, _rand(shape[0], shape[0], seed=11), split)
    jq, tq = ht.SquareDiagTiles(jo, per), htt.SquareDiagTiles(to, per)
    jq.match_tiles(jt)
    tq.match_tiles(tt)
    assert tq.row_indices == jq.row_indices and tq.col_indices == jq.col_indices
    _bitwise(jq.tile_map, tq.tile_map)
    with pytest.raises(ValueError):
        htt.SquareDiagTiles(htt.array(x, device="cpu"))


# -------------------------------------------------------------- mpi_topk
@pytest.mark.parametrize("largest", (True, False))
def test_mpi_topk(ht, largest):
    rng = np.random.default_rng(12)
    av = np.sort(rng.integers(0, 5, size=(3, 4)).astype(np.float32), axis=1)[:, ::-1 if largest else 1].copy()
    bv = np.sort(rng.integers(0, 5, size=(3, 4)).astype(np.float32), axis=1)[:, ::-1 if largest else 1].copy()
    ai, bi = np.arange(12).reshape(3, 4), np.arange(12).reshape(3, 4) + 100
    want = ht.mpi_topk((av, ai), (bv, bi), largest=largest)
    got = htt.mpi_topk((av, ai), (bv, bi), largest=largest)
    _bitwise(np.asarray(want[0]), got[0].numpy())
    _bitwise(np.asarray(want[1]), got[1].numpy())
    want = ht.mpi_topk((av.T.copy(), ai.T.copy()), (bv.T.copy(), bi.T.copy()), dim=0, largest=largest)
    got = htt.mpi_topk((htt.array(av.T.copy(), device="cpu"), ai.T.copy()), (bv.T.copy(), bi.T.copy()), dim=0,
                       largest=largest)
    _bitwise(np.asarray(want[0]), got[0].numpy())
    _bitwise(np.asarray(want[1]), got[1].numpy())


# ---------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("full", "same", "valid"))
def test_convolve_on_card(cuda, mode):
    g = torch.Generator().manual_seed(13)
    a, v = torch.randn(1_000_003, generator=g), torch.randn(257, generator=g)
    mesh = htt.MeshComm(4)
    got = htt.convolve(htt.array(a.to(cuda), split=0, comm=mesh), v.to(cuda), mode=mode)
    again = htt.convolve(htt.array(a.to(cuda), split=0, comm=mesh), v.to(cuda), mode=mode)
    want = htt.convolve(htt.array(a, split=0, comm=mesh, device="cpu"), v, mode=mode)
    assert torch.equal(got.larray, again.larray)
    assert [s.shape for s in got.shards] == [s.shape for s in want.shards]
    tol = 1e-5 * float(v.abs().sum() * a.abs().max())
    assert float((got.larray.cpu() - want.larray).abs().max()) <= tol
