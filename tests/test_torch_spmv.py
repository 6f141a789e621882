"""K6, the sparse matrix-vector kernel: heat_tpu_torch's ELL packer, the
kernel's repacking by column panel and both plain versions against
heat_tpu on the CPU, a CPU emulation of the kernel's summation order
against heat_tpu, and the CUDA kernel against its plain version on the
card.

Tolerance: the two sum a row's products in different orders, so
|Δy| ≤ 1e-6·Σⱼ|vals·x| per row on real-valued data (1e-5 on the card, where
the kernel's butterfly order differs more); on integer-valued data every
partial sum is exact and the results are bitwise equal.  heat_tpu's static
``sparse.matmul`` (its autotune off, the conftest default) is the ``gather``
arm; its kernel runs in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

from heat_tpu_torch.ops import spmv as k6


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _csr(n, m, density=0.15, seed=0, zero_rows=(), integer=False, long_row=None, band=None, **_):
    """A random (n, m) CSR matrix, sorted; ``band=(c0, c1)`` keeps every
    entry in columns [c0, c1)."""
    rng = np.random.default_rng(seed)
    if band is None:
        sp = scipy.sparse.random(n, m, density=density, random_state=rng, format="csr", dtype=np.float32)
    else:
        c0, c1 = band
        inner = scipy.sparse.random(n, c1 - c0, density=density, random_state=rng, format="coo", dtype=np.float32)
        sp = scipy.sparse.csr_matrix((inner.data, (inner.row, inner.col + c0)), shape=(n, m))
    if integer:
        sp.data = (np.abs(sp.data * 900).astype(np.int64) % 7 + 1).astype(np.float32)
    lil = sp.tolil()
    for r in zero_rows:
        lil.rows[r] = []
        lil.data[r] = []
    if long_row is not None:
        lil.rows[long_row] = list(range(m))
        row = rng.integers(1, 8, size=m) if integer else rng.normal(size=m)
        lil.data[long_row] = list(row.astype(np.float32))
    sp = lil.tocsr()
    sp.sort_indices()
    return sp


def _x(m, k=None, seed=1, integer=False):
    rng = np.random.default_rng(seed)
    shape = (m,) if k is None else (m, k)
    if integer:
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _pack(sp):
    width = k6.ell_width(int(np.diff(sp.indptr).max()) if sp.shape[0] else 0)
    return k6.ell_pack(torch.from_numpy(sp.data), torch.from_numpy(sp.indices), torch.from_numpy(sp.indptr), width)


def _panels(sp, device="cpu"):
    """The kernel's operand for ``sp``, built from its CSR triple."""
    t = (torch.from_numpy(a).to(device) for a in (sp.data, sp.indices, sp.indptr))
    return k6.csr_panels(*t, sp.shape[1])


def _scale(sp, x):
    """Σⱼ|vals·x| per row (and column of x)."""
    a = abs(sp).astype(np.float64)
    return a @ np.abs(x.astype(np.float64))


CASES = [
    dict(n=40, m=64, seed=3),
    dict(n=37, m=52, seed=5, zero_rows=tuple(range(33, 37))),
    dict(n=64, m=300, seed=6, zero_rows=(0, 1, 31), long_row=17),
    dict(n=1, m=5, seed=7, density=1.0),
]


@pytest.mark.parametrize("n,w", [(0, 32), (1, 32), (32, 32), (33, 64), (129, 160)])
def test_width_rounds_to_a_warp(n, w):
    assert k6.ell_width(n) == w


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
def test_pack_live_slots_equal_jax(ht, case):
    sp = _csr(**case)
    vals, cols = _pack(sp)
    assert vals.dtype == torch.float32 and cols.dtype == torch.int32
    assert tuple(vals.shape) == (sp.shape[0], k6.ell_width(int(np.diff(sp.indptr).max())))
    jw = ht.ops.spmv.ell_width(int(np.diff(sp.indptr).max()))
    jv, jc = ht.ops.spmv.ell_pack(sp.data, sp.indices, sp.indptr, jw)
    counts = np.diff(sp.indptr)
    v, c = vals.numpy(), cols.numpy()
    for r, cnt in enumerate(counts):
        np.testing.assert_array_equal(v[r, :cnt], jv[r, :cnt])
        np.testing.assert_array_equal(c[r, :cnt], jc[r, :cnt])
        assert np.all(c[r, cnt:] == -1) and np.all(v[r, cnt:] == 0)


def test_pack_rejects_a_row_wider_than_the_slab():
    sp = _csr(8, 40, density=1.0, seed=2)
    with pytest.raises(ValueError):
        k6.ell_pack(torch.from_numpy(sp.data), torch.from_numpy(sp.indices), torch.from_numpy(sp.indptr), 32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
@pytest.mark.parametrize("k", [None, 1, 4])
def test_reference_against_jax_interpret(ht, case, k):
    sp = _csr(**case)
    x = _x(sp.shape[1], k, seed=case["seed"] + 10)
    jw = ht.ops.spmv.ell_width(int(np.diff(sp.indptr).max()))
    jv, jc = ht.ops.spmv.ell_pack(sp.data, sp.indices, sp.indptr, jw)
    x2 = x[:, None] if x.ndim == 1 else x
    want = np.stack([np.asarray(ht.ops.spmv.spmv_ell(jv, jc, x2[:, j], interpret=True))[: sp.shape[0]]
                     for j in range(x2.shape[1])], axis=1)
    vals, cols = _pack(sp)
    for got in (k6.reference_spmv_ell(vals, cols, torch.from_numpy(x)).numpy(),
                k6.reference_spmv(_panels(sp), torch.from_numpy(x)).numpy()):
        assert got.dtype == np.float32 and got.shape == x.shape[:0] + (sp.shape[0],) + x.shape[1:]
        got2 = got[:, None] if got.ndim == 1 else got
        assert np.all(np.abs(got2 - want) <= 1e-6 * _scale(sp, x2) + 1e-30)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['n']}x{c['m']}")
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("integer", [False, True])
def test_reference_against_jax_gather_arm(ht, case, k, integer):
    sp = _csr(**case, integer=integer)
    x = _x(sp.shape[1], k, seed=case["seed"] + 20, integer=integer)
    want = ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy()
    vals, cols = _pack(sp)
    for got in (k6.reference_spmv_ell(vals, cols, torch.from_numpy(x)).numpy(),
                k6.reference_spmv(_panels(sp), torch.from_numpy(x)).numpy()):
        assert got.shape == want.shape
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            scale = _scale(sp, x[:, None] if x.ndim == 1 else x).reshape(got.shape)
            assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


def test_wrapper_on_cpu_is_the_plain_version():
    sp = _csr(30, 45, seed=8)
    panels = _panels(sp)
    x = torch.from_numpy(_x(45, 4, seed=9))
    before = k6.launches
    torch.testing.assert_close(k6.spmv(panels, x), k6.reference_spmv(panels, x), rtol=0, atol=0)
    assert k6.launches == before


def test_zero_row_block():
    empty = k6.csr_panels(torch.zeros(0), torch.zeros(0, dtype=torch.int32), torch.zeros(1, dtype=torch.int64), 7)
    y = k6.spmv(empty, torch.ones(7, 3))
    assert tuple(y.shape) == (0, 3) and y.dtype == torch.float32


def test_wrapper_rejects_bad_shapes():
    panels = _panels(_csr(4, 5, seed=2))
    with pytest.raises(ValueError):
        k6.spmv(panels, torch.zeros(6))
    with pytest.raises(ValueError):
        k6.spmv(panels, torch.zeros(5, 2, 2))
    with pytest.raises(TypeError):
        k6.spmv(tuple(panels)[:3], torch.zeros(5))


# ---------------------------------------------- the kernel's order, emulated
_K6_SRC = (Path(__file__).resolve().parent.parent / "heat_tpu_torch" / "csrc" / "spmv.cu").read_text()


def _src_int(name):
    """A ``constexpr int`` of csrc/spmv.cu: a product of literals and
    earlier constants."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", _K6_SRC).group(1)
    out = 1
    for term in (t.strip() for t in expr.split("*")):
        out *= int(term) if term.isdigit() else _src_int(term)
    return out


SUB_COLS, TILE_ROWS, UNROLL = _src_int("kSubCols"), _src_int("kTileRows"), _src_int("kUnroll")
WARPS = _src_int("kThreads") // 32


def test_wrapper_geometry_is_the_sources():
    assert (k6.PANEL_COLS, k6.TILE_ROWS, k6.UNROLL) == (SUB_COLS, TILE_ROWS, UNROLL)
    assert TILE_ROWS == 32 * WARPS  # a lane owns one row of a tile


def _fma(a, b, c):
    """f32 fmaf: the f64 product of two f32 values is exact, one rounding
    of the sum to f64 and one to f32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _emulate(panels, x, sms=132, mutate=None):
    """csrc/spmv.cu's sums in its order, for x (ncols, k): every tile's
    warps own their rows (each row exactly once: asserted); a row's run in
    panel p is [off[p·rows + r], off[p·rows + r + 1]) of the repacking; TPR
    lanes each fmaf the run's slots in their quads a/4 + l + m·TPR in
    order; an xor butterfly adds the lanes; the row adds the panel sums in
    panel order."""
    pv, pc, off = (t.numpy() for t in panels[:3])
    rows = panels.rows
    ncols, k = x.shape
    geo = k6.plan(rows, ncols, panels.nnz, k, sms, panels.staged)
    # the band split: tiles of tile_rows, a warp's share of a tile, a lane a row
    owner = np.zeros(rows, np.int64)
    for t in range(geo.tiles):
        tn = min(geo.tile_rows, rows - t * geo.tile_rows)
        for w in range(WARPS):
            lo, hi = w * tn // WARPS, (w + 1) * tn // WARPS
            if mutate == "band":
                hi -= 1
            assert hi - lo <= 32
            owner[t * geo.tile_rows + lo : t * geo.tile_rows + hi] += 1
    assert geo.grid <= geo.tiles and np.all(owner == 1), "every row is owned by exactly one lane"
    r = np.arange(rows)
    y = np.zeros((rows, k), np.float32)
    for col in range(k):
        xc = x[:, col].astype(np.float32)
        acc = np.zeros(rows, np.float32)
        for p in range(geo.panels - 1 if mutate == "last panel" else geo.panels):
            a, b = off[p * rows + r].astype(np.int64), off[p * rows + r + 1].astype(np.int64)
            if mutate == "run":
                b = np.maximum(b - 1, a)
            part = np.zeros((geo.tpr, rows), np.float32)
            steps = -(-int((((b + 3) >> 2) - (a >> 2)).max(initial=0)) // geo.tpr)
            for lane in range(geo.tpr):
                for m in range(steps):
                    qd = (a >> 2) + lane + m * geo.tpr
                    for e in range(4):
                        slot = 4 * qd + e
                        live = (slot >= a) & (slot < b)
                        safe = np.where(live, slot, 0)
                        xv = xc[np.where(live, pc[safe], 0)]
                        part[lane] = np.where(live, _fma(pv[safe], xv, part[lane]), part[lane])
            off_ = geo.tpr // 2
            while off_:
                part = part + part[np.arange(geo.tpr) ^ off_]
                off_ //= 2
            acc = acc + part[0]
        y[:, col] = acc
    return y


EMU_CASES = CASES + [
    dict(n=24, m=60_001, seed=21, density=0.004, id="3 panels"),
    dict(n=33, m=50_000, seed=22, density=0.02, band=(30_720, 31_720), zero_rows=(0, 5, 32), id="one panel"),
    dict(n=3, m=70_001, seed=23, density=0.0005, long_row=1, id="a row over every column"),
    dict(n=40, m=60_001, seed=24, density=0.0002, id="sparse rows, one run a row"),
]


def _emu_id(c):
    return c.get("id", f"{c['n']}x{c['m']}")


@pytest.mark.parametrize("case", EMU_CASES, ids=_emu_id)
@pytest.mark.parametrize("k", [1, 4, 5])
def test_emulated_order_against_jax(ht, case, k):
    sp = _csr(**case)
    x = _x(sp.shape[1], k, seed=case["seed"] + 40)
    got = _emulate(_panels(sp), x)
    want = ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * _scale(sp, x) + 1e-30)
    if k == 1:
        jw = ht.ops.spmv.ell_width(int(np.diff(sp.indptr).max()))
        jv, jc = ht.ops.spmv.ell_pack(sp.data, sp.indices, sp.indptr, jw)
        interp = np.asarray(ht.ops.spmv.spmv_ell(jv, jc, x[:, 0], interpret=True))[: sp.shape[0]]
        assert np.all(np.abs(got[:, 0] - interp) <= 1e-6 * _scale(sp, x)[:, 0] + 1e-30)


@pytest.mark.parametrize("case", EMU_CASES, ids=_emu_id)
def test_emulated_order_is_bitwise_on_integer_data(ht, case):
    sp = _csr(**case, integer=True)
    x = _x(sp.shape[1], 4, seed=case["seed"] + 50, integer=True)
    got = _emulate(_panels(sp), x)
    np.testing.assert_array_equal(got, ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy())
    np.testing.assert_array_equal(got, k6.reference_spmv_ell(*_pack(sp), torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("mutate", ["run", "last panel", "band"])
def test_emulation_mutations_fail(ht, mutate):
    """The emulation's checks catch a run bound off by one, a skipped last
    panel and a band that leaves a row out."""
    case = EMU_CASES[-4]
    sp = _csr(**case)
    x = _x(sp.shape[1], 1, seed=1)
    panels = _panels(sp)
    want = ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy()
    with pytest.raises(AssertionError):
        got = _emulate(panels, x, mutate=mutate)
        assert np.all(np.abs(got - want) <= 1e-6 * _scale(sp, x) + 1e-30)


@pytest.mark.parametrize("case", EMU_CASES, ids=_emu_id)
def test_panels_hold_each_rows_slots_by_panel(case):
    """Run (s, r) of the repacking holds row r's entries with a column in
    panel s, in CSR order; its length is numpy's searchsorted of the row's
    sorted columns at the panel bounds; nothing else is stored."""
    sp = _csr(**case)
    panels = _panels(sp)
    pv, pc, off = panels[:3]
    rows = sp.shape[0]
    nsub = -(-sp.shape[1] // SUB_COLS) if panels.staged else 1
    assert (panels.rows, panels.ncols, panels.nnz) == (rows, sp.shape[1], sp.nnz)
    assert off.dtype == torch.int32 and off.numel() == nsub * rows + 1 and int(off[-1]) == sp.nnz
    assert pv.numel() % 4 == 0 and sp.nnz <= pv.numel() < sp.nnz + 4 + 4 * (sp.nnz == 0)
    off = off.numpy().astype(np.int64)
    bounds = np.arange(nsub + 1) * SUB_COLS if panels.staged else np.array([0, sp.shape[1]])
    for r in range(rows):
        live = sp.indices[sp.indptr[r] : sp.indptr[r + 1]]
        lens = np.diff(np.searchsorted(live, bounds))
        for s in range(nsub):
            lo, hi = off[s * rows + r], off[s * rows + r + 1]
            assert hi - lo == lens[s]
            keep = (live >= bounds[s]) & (live < bounds[s + 1])
            np.testing.assert_array_equal(pc[lo:hi].numpy(), live[keep])
            np.testing.assert_array_equal(pv[lo:hi].numpy(), sp.data[sp.indptr[r] : sp.indptr[r + 1]][keep])


def test_panels_of_rows_out_of_column_order(ht):
    """A CSR triple whose rows are not in column order: each run keeps CSR
    order, and the emulated kernel still equals the gather arm bitwise on
    integer data."""
    sp = _csr(20, 13_000, density=0.01, seed=31, integer=True)
    rng = np.random.default_rng(32)
    perm = np.concatenate([lo + rng.permutation(hi - lo) for lo, hi in zip(sp.indptr[:-1], sp.indptr[1:])])
    shuffled = scipy.sparse.csr_matrix((sp.data[perm], sp.indices[perm], sp.indptr), shape=sp.shape)
    panels = _panels(shuffled)
    runs = np.diff(panels.off.numpy().astype(np.int64)).reshape(-1, 20)
    assert np.array_equal(runs.sum(0), np.diff(sp.indptr))
    x = _x(13_000, 4, seed=33, integer=True)
    got = _emulate(panels, x)
    np.testing.assert_array_equal(got, ht.sparse.matmul(ht.sparse.sparse_csr_matrix(sp), ht.array(x)).numpy())


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("rows,nnz,ncols,k", [(131_072, 34_325_272, 131_072, 1), (131_072, 34_325_272, 131_072, 4),
                                              (65_536, 693_792, 65_536, 1), (5003, 150_000, 3001, 5), (1, 3, 5, 1),
                                              (1_000_003, 9_000_000, 900, 2)])
def test_plan_covers_the_rows(rows, nnz, ncols, k, staged):
    geo = k6.plan(rows, ncols, nnz, k, 132, staged)
    assert geo.tile_rows <= TILE_ROWS and (geo.tiles - 1) * geo.tile_rows < rows <= geo.tiles * geo.tile_rows
    assert 1 <= geo.grid <= min(132, geo.tiles) and geo.tpr in (2, 4, 8, 16)
    assert geo.passes == (1 if k == 1 else -(-k // 4)) and geo.kc == (1 if k == 1 else 4)
    assert geo.panels == (-(-ncols // SUB_COLS) if staged else 1)


@pytest.mark.parametrize("case,staged", [
    (dict(n=300, m=60_001, density=0.004), True),  # 240 entries a row over 10 panels
    (dict(n=300, m=60_001, density=0.0006), False),  # 36: under a quad a panel
    (dict(n=40, m=64, density=0.15), True),  # one panel of 9.6 entries a row
    (dict(n=40, m=64, density=0.04), False),
])
def test_repacking_stages_x_where_rows_fill_a_quad_a_panel(case, staged):
    """x is staged in panels where a row holds STAGE_RUN entries a panel on
    average; else the repacking is one run a row, the CSR's order."""
    sp = _csr(**case)
    panels = _panels(sp)
    assert panels.staged is staged
    assert staged == (sp.nnz >= k6.STAGE_RUN * sp.shape[0] * -(-sp.shape[1] // SUB_COLS))
    if not staged:
        np.testing.assert_array_equal(panels.off.numpy(), sp.indptr)
        np.testing.assert_array_equal(panels.cols[: sp.nnz].numpy(), sp.indices)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = CASES + [
    dict(n=5000, m=3000, seed=11, density=0.01, zero_rows=(0, 4999)),
    # the panels' edges: x over 3 panels at k = 1 (10 at k = 4), also one
    # f32 element off 16 bytes; every row inside one panel with empty rows
    # (and empty runs); one row over every column; the CSR arrays one
    # element off 16 bytes (the kernel reads their repacking); a row count
    # off the tiles with an odd column count; ~12 entries a row over 10
    # panels, which gather x from memory (the rest stage it)
    dict(n=3001, m=60_001, seed=41, density=0.003, id="3 panels"),
    dict(n=3001, m=60_001, seed=41, density=0.003, x_off=1, id="3 panels, x one element off"),
    dict(n=2050, m=50_000, seed=42, density=0.05, band=(30_720, 31_720), zero_rows=(0, 7, 2049),
         id="one panel, empty rows"),
    dict(n=7, m=70_001, seed=43, density=0.0005, long_row=3, id="a row over every column"),
    dict(n=500, m=30_000, seed=45, density=0.004, csr_off=1, id="CSR one element off"),
    dict(n=5003, m=3001, seed=44, density=0.01, id="5003 rows, odd columns"),
    dict(n=20_000, m=60_001, seed=46, density=0.0002, id="sparse rows over 10 panels"),
]


def test_card_cases_cover_both_modes():
    """The repacking the cases below choose for themselves reaches both of
    the kernel's modes: x staged in shared memory, x from memory."""
    direct = [c.get("id") for c in CARD_CASES if not _panels(_csr(**c)).staged]
    assert direct == ["sparse rows over 10 panels"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=_emu_id)
@pytest.mark.parametrize("k", [None, 1, 4, 5])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("stage_run", [None, 0, float("inf")], ids=["chosen", "staged", "one run a row"])
def test_kernel_against_plain_on_card(cuda, monkeypatch, case, k, integer, stage_run):
    sp = _csr(**case, integer=integer)
    x = _x(sp.shape[1], k, seed=case["seed"] + 30, integer=integer)

    def shifted(a, by):  # ``a`` on the card, ``by`` elements past a 16-byte boundary
        t = torch.from_numpy(a)
        return torch.cat([t.new_zeros(by), t.reshape(-1)]).to(cuda)[by:].view(t.shape)

    if stage_run is not None:  # force one layout: every matrix staged, or none
        monkeypatch.setattr(k6, "STAGE_RUN", stage_run)
    by = case.get("csr_off", 0)
    panels = k6.csr_panels(shifted(sp.data, by), shifted(sp.indices, by), shifted(sp.indptr, by), sp.shape[1])
    assert stage_run is None or panels.staged is (stage_run == 0)
    xt = shifted(x, case.get("x_off", 0))
    before = k6.launches
    got = k6.spmv(panels, xt)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and tuple(got.shape) == (sp.shape[0],) + x.shape[1:]
    want = k6.reference_spmv(panels, xt)
    vals, cols = (t.to(cuda) for t in _pack(sp))
    want_ell = k6.reference_spmv_ell(vals, cols, xt)
    if integer:
        assert torch.equal(got, want) and torch.equal(got, want_ell)
    else:
        scale = _scale(sp, x[:, None] if x.ndim == 1 else x).reshape(got.shape)
        for w in (want, want_ell):
            assert np.all(np.abs(got.cpu().numpy() - w.cpu().numpy()) <= 1e-5 * scale + 1e-30)
    # a fixed summation order: a second launch is bitwise equal
    assert torch.equal(k6.spmv(panels, xt), got)


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    panels = _panels(_csr(4, 6, seed=3), cuda)
    x = torch.zeros(6, device=cuda)
    with pytest.raises(TypeError):
        k6.spmv(panels, x.double())
    with pytest.raises(TypeError):
        k6.spmv(tuple(panels)[:3], x)
    with pytest.raises(ValueError):
        k6.spmv(panels, torch.zeros(7, device=cuda))
    with pytest.raises(ValueError):
        k6.spmv(panels, x.cpu())
    with pytest.raises(ValueError):
        k6.spmv(_panels(_csr(4, 6, seed=3)), x)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_kernel_reruns_bitwise_at_the_cell(cuda, k):
    """The SpMV cell, 131072^2 at density 0.002 (staged): within 1e-5 of
    plain and a rerun bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 131_072
    lin = torch.unique(torch.randint(0, n * n, (int(0.002 * n * n),), generator=gen, device=cuda))
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=cuda)
    ptr[1:] = torch.cumsum(torch.bincount(lin // n, minlength=n), 0)
    data, cols = torch.rand(lin.numel(), generator=gen, device=cuda), (lin % n).to(torch.int32)
    panels = k6.csr_panels(data, cols, ptr, n)
    x = torch.randn(n, k, generator=gen, device=cuda)
    got = k6.spmv(panels, x)
    assert torch.equal(k6.spmv(panels, x), got)
    want = k6.reference_spmv(panels, x)
    scale = k6.reference_spmv(panels, x.abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())
