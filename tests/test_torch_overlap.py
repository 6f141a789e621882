"""``heat_tpu_torch.parallel.overlap`` against heat_tpu's ring engine on the
CPU (mirrors tests/test_overlap.py).

Both packages run with the dispatch mode forced (``set_mode``) and the
tuning plane off, so no wall clock decides anything.  The three schedules
(``ag``, ``rs`` with each out-split, ``col``) with and without an epilogue
at meshes 1/4/8, on uneven 13 x 7 x 11 operands: values within 1e-5 of
sum_k |a||b| (f32 block sums in other orders; one bf16 ulp after an epilogue
cast), the same dtypes, splits, shapes and ``stats()["last"]``; bf16
operands at mesh 4.  The tuned wire leaves rings on one device exact.  ``_decide``
over a grid of sizes and modes.  Chains through ``linalg.matmul`` under
fusion: the same cache counts and overlap counters as heat_tpu's, the fused
values bitwise the port's eager ring.  The ring's callers:
``orthogonality_defect``, ``_update_centroids``, the int8
``matmul_quantized`` ring and the ring ``cdist``/``cdist_quantized``
(K1's plain version on the CPU, S calls a position).
"""

import importlib

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import fusion as PF
from heat_tpu_torch.core import quantize as TQ
from heat_tpu_torch.ops import cdist as k1
from heat_tpu_torch.parallel import overlap as PO

MESHES = (1, 4, 8)
M, K, N = 13, 7, 11
# (a split, b split, requested out-split)
CASES = {"ag": (0, 0, "auto"), "rs-none": (1, 0, "auto"), "rs-0": (1, 0, 0), "rs-1": (1, 0, 1),
         "col": (1, 1, "auto")}


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JO(ht):
    from heat_tpu.parallel import overlap

    return overlap


@pytest.fixture
def modes(JO):
    """Restores both packages' dispatch mode and counters after a test."""
    yield
    for mod in (JO, PO):
        mod.set_mode(None)
        mod.reset_stats()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _tol(a, b):
    """1e-5 of sum_k |a_ik| |b_kj|: f32 block sums in another order."""
    return 1e-5 * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))


def _f32(ht, x):
    import jax.numpy as jnp

    if isinstance(x, htt.DNDarray):
        return x.larray.to(torch.float32).numpy()
    return np.asarray(x.larray.astype(jnp.float32))


def _epilogues(ht, JO):
    import jax
    import jax.numpy as jnp

    scale, bias = _rand((N,), 3), _rand((M, 1), 4)
    return {
        "none": (None, None),
        "full": (
            JO.Epilogue(scale=scale, bias=bias, activation=jax.nn.relu, dtype=jnp.bfloat16),
            PO.Epilogue(scale=torch.from_numpy(scale), bias=torch.from_numpy(bias), activation=torch.relu,
                        dtype=torch.bfloat16),
        ),
    }


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_ring_schedules_match_heat_tpu(ht, JO, modes, n, case):
    a_np, b_np = _rand((M, K), 1), _rand((K, N), 2)
    sa, sb, out = CASES[case]
    jc, tc = _pair(ht, n)
    tol = _tol(a_np, b_np)
    for ep_name, (ja, pa) in _epilogues(ht, JO).items():
        for mode in ("ring", "gspmd"):
            JO.set_mode(mode)
            PO.set_mode(mode)
            want = JO.matmul(ht.array(a_np, split=sa, comm=jc), ht.array(b_np, split=sb, comm=jc), out_split=out,
                             epilogue=ja)
            got = PO.matmul(htt.array(a_np, split=sa, comm=tc, device="cpu"),
                            htt.array(b_np, split=sb, comm=tc, device="cpu"), out_split=out, epilogue=pa)
            assert PO.stats()["last"] == JO.stats()["last"], (ep_name, mode)
            assert (got is None) == (want is None), (ep_name, mode)
            if got is None:
                continue
            assert got.split == want.split and got.shape == want.shape
            assert got.dtype.__name__ == want.dtype.__name__
            w, g = _f32(ht, want), _f32(ht, got)
            if ep_name == "none":
                np.testing.assert_array_less(np.abs(g - w), tol + 1e-30)
            else:
                # one bf16 ulp of the value, beside the f32 rounding
                np.testing.assert_array_less(np.abs(g - w), np.abs(w) * 2.0**-7 + tol * np.abs(_rand((N,), 3))
                                             + 1e-30)
            assert np.array_equal(np.asarray(got.lshape_map), np.asarray(want.lshape_map))


@pytest.mark.parametrize("case", list(CASES))
def test_ring_schedules_bf16_operands_match_heat_tpu(ht, JO, modes, case):
    # bf16 operands: heat_tpu's blocks are bf16 products with an f32 result
    # and accumulator, cast to bf16 at the end; the port's the same on the
    # card's tensor cores (the CPU widens first: the same exact products)
    ml = pytest.importorskip("ml_dtypes")
    a16 = torch.from_numpy(_rand((M, K), 5)).to(torch.bfloat16)
    b16 = torch.from_numpy(_rand((K, N), 6)).to(torch.bfloat16)
    a_np, b_np = (t.view(torch.int16).numpy().view(ml.bfloat16).copy() for t in (a16, b16))
    sa, sb, out = CASES[case]
    jc, tc = _pair(ht, 4)
    JO.set_mode("ring")
    PO.set_mode("ring")
    want = JO.matmul(ht.array(a_np, split=sa, comm=jc), ht.array(b_np, split=sb, comm=jc), out_split=out)
    got = PO.matmul(htt.array(a16, split=sa, comm=tc, device="cpu"), htt.array(b16, split=sb, comm=tc, device="cpu"),
                    out_split=out)
    assert PO.stats()["last"] == JO.stats()["last"]
    assert got.dtype is htt.bfloat16 and want.dtype.__name__ == "bfloat16"
    assert got.split == want.split and got.shape == want.shape
    w, g = _f32(ht, want), _f32(ht, got)
    af, bf = a16.to(torch.float32).numpy(), b16.to(torch.float32).numpy()
    # one bf16 ulp of the value where the f32 sums round to either side
    np.testing.assert_array_less(np.abs(g - w), np.abs(w) * 2.0**-7 + _tol(af, bf) + 1e-30)


def test_decide_matches_heat_tpu(JO, modes, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_MATMUL_RING_MIN_BYTES", str(1 << 16))
    rows = []
    for mode in ("auto", "gspmd", "ring"):
        JO.set_mode(mode)
        PO.set_mode(mode)
        for case in ("ag", "rs", "col", None):
            for out in (None, 0, 1):
                for S in (1, 2, 4, 8):
                    for m, k, n in ((13, 7, 11), (512, 300, 257), (64, 4096, 64), (1, 1, 1)):
                        for comp_isz, acc_isz in ((4, 4), (2, 4), (8, 8)):
                            args = (case, out, m, k, n, S, comp_isz, acc_isz)
                            rows.append(PO._decide(*args) == JO._decide(*args))
    assert all(rows) and len(rows) == 3 * 4 * 3 * 4 * 4 * 3
    assert PO._classify(1, 0) == JO._classify(1, 0) == "rs"


def _chains(H, F, comm, a_np, b_np, c_np, **dev):
    """heat_tpu's chain sequence through linalg.matmul, with the fusion and
    overlap counts after each step."""
    rows, vals = [], []
    a = H.array(a_np, split=0, comm=comm, **dev)
    b = H.array(b_np, split=0, comm=comm, **dev)
    c = H.array(c_np, comm=comm, **dev)

    def counts(tag):
        st, ov = F.cache_stats(), (H.parallel.overlap.stats())
        rows.append((tag, st["misses"], st["hits"], ov["ring_calls"], ov["gspmd_calls"], ov["ring_builds"],
                     dict(ov["by_schedule"])))

    for i in range(2):
        vals.append(H.abs(H.matmul(a, b) + c).numpy())
        counts(f"abs(a@b + c) #{i}")
    vals.append(H.matmul(a, b).astype(H.float64).numpy())
    counts("cast")
    vals.append(H.sum(H.matmul(a, b) * 2.0, axis=1).numpy())
    counts("reduction tail declines")
    pending = a * 2.0
    vals.append(H.matmul(pending, b).numpy())
    counts("a pending operand")
    bt = H.array(b_np, split=1, comm=comm, **dev)
    vals.append((H.matmul(a, bt) - 1.0).numpy())
    counts("layout declines")
    return rows, vals


@pytest.mark.parametrize("n", [1, 4])
def test_chains_through_matmul_match_heat_tpu(ht, JO, modes, n):
    from heat_tpu.core import fusion as JF

    a_np, b_np, c_np = _rand((16, 12), 5), _rand((12, 8), 6), _rand((8,), 7)
    jc, tc = _pair(ht, n)
    for mod in (JO, PO):
        mod.set_mode("ring")
        mod.reset_stats()
    JF.reset_cache()
    PF.reset_cache()
    want_rows, want = _chains(ht, JF, jc, a_np, b_np, c_np)
    got_rows, got = _chains(htt, PF, tc, a_np, b_np, c_np, device="cpu")
    assert got_rows == want_rows
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # relu(a@b + c): the port's maximum rides the ring's tail (heat_tpu
    # leaves maximum out of its op table, so its chain declines there); the
    # fused values are bitwise the port's eager ones (the same ring)
    a = htt.array(a_np, split=0, comm=tc, device="cpu")
    b = htt.array(b_np, split=0, comm=tc, device="cpu")
    c = htt.array(c_np, comm=tc, device="cpu")
    PO.reset_stats()
    fused = htt.maximum(htt.matmul(a, b) + c, 0.0).numpy()
    assert PO.stats()["calls"] == 1
    with PF.fuse(False):
        eager = htt.maximum(htt.matmul(a, b) + c, 0.0).numpy()
    np.testing.assert_array_equal(fused, eager)
    want = ht.maximum(ht.matmul(ht.array(a_np, split=0, comm=jc), ht.array(b_np, split=0, comm=jc))
                      + ht.array(c_np, comm=jc), 0.0).numpy()
    np.testing.assert_allclose(fused, want, rtol=1e-5, atol=1e-5)


def test_matmul_defers_without_reading_its_operands(modes):
    tc = htt.MeshComm(4)
    PO.set_mode("ring")
    a = htt.array(_rand((16, 12), 8), split=0, comm=tc, device="cpu")
    b = htt.array(_rand((12, 8), 9), split=0, comm=tc, device="cpu")
    pending = a * 2.0
    out = htt.matmul(pending, b)
    assert isinstance(out, PF.LazyDNDarray) and PF._pending(out) and PF._pending(pending)
    np.testing.assert_allclose(out.numpy(), (a.numpy() * 2.0) @ b.numpy(), rtol=1e-5, atol=1e-5)


def test_a_matcher_that_raises_raises(monkeypatch, modes):
    def broken(*args):
        raise RuntimeError("matcher fault")

    monkeypatch.setattr(PF, "_TERMINATORS", [(broken, None)])
    PF.reset_cache()
    tc = htt.MeshComm(4)
    a = htt.array(_rand((16, 12), 10), split=0, comm=tc, device="cpu")
    b = htt.array(_rand((12, 8), 11), split=0, comm=tc, device="cpu")
    with pytest.raises(RuntimeError, match="matcher fault"):
        (htt.matmul(a, b) + 1.0).numpy()
    PF.reset_cache()


@pytest.mark.parametrize("n", [4, 8])
def test_ring_callers_match_heat_tpu(ht, JO, modes, n):
    JQ = importlib.import_module("heat_tpu.core.quantize")
    jqr = importlib.import_module("heat_tpu.core.linalg.qr")
    tqr = importlib.import_module("heat_tpu_torch.core.linalg.qr")
    jc, tc = _pair(ht, n)
    for mod in (JO, PO):
        mod.set_mode("ring")
        mod.reset_stats()
    # orthogonality_defect: the rs ring, out replicated
    q_np = np.linalg.qr(_rand((64, 6), 12))[0].astype(np.float32)
    want = float(jqr.orthogonality_defect(ht.array(q_np, split=0, comm=jc)).item())
    got = float(tqr.orthogonality_defect(htt.array(q_np, split=0, comm=tc, device="cpu")).item())
    assert PO.stats()["last"] == JO.stats()["last"] and PO.stats()["last"]["schedule"] == "ring_rs"
    assert abs(got - want) <= 1e-6
    # the one-hot centroid sums
    x_np, lab = _rand((40, 5), 13), np.random.default_rng(14).integers(0, 3, 40)
    init = _rand((3, 5), 15)
    jk = ht.cluster.KMeans(n_clusters=3, init=ht.array(init, comm=jc))
    tk = htt.cluster.KMeans(n_clusters=3, init=htt.array(init, comm=tc, device="cpu"))
    jk._cluster_centers = ht.array(init, comm=jc)
    tk._cluster_centers = htt.array(init, comm=tc, device="cpu")
    want = jk._update_centroids(ht.array(x_np, split=0, comm=jc), ht.array(lab[:, None], split=0, comm=jc))
    got = tk._update_centroids(htt.array(x_np, split=0, comm=tc, device="cpu"),
                               htt.array(lab[:, None], split=0, comm=tc, device="cpu"))
    assert PO.stats()["last"] == JO.stats()["last"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    # the int8 arm of matmul_quantized, ring-first with the scale and the
    # cast in the epilogue
    x_np, w_np = _rand((16, 24), 16), _rand((24, 12), 17)
    for xs, ws in ((0, 0), (1, 0), (1, 1)):
        qa = JQ.quantize_weights(ht.array(w_np, split=ws, comm=jc), "int8", axis=1)
        qb = TQ.quantize_weights(htt.array(w_np, split=ws, comm=tc, device="cpu"), "int8", axis=1)
        ya = JQ.matmul_quantized(ht.array(x_np, split=xs, comm=jc), qa, arm="int8")
        yb = TQ.matmul_quantized(htt.array(x_np, split=xs, comm=tc, device="cpu"), qb, arm="int8")
        assert PO.stats()["last"] == JO.stats()["last"] and PO.stats()["last"]["schedule"] != "gspmd"
        assert yb.split == ya.split and yb.shape == ya.shape and yb.dtype.__name__ == ya.dtype.__name__
        want = ya.numpy()
        np.testing.assert_allclose(yb.numpy(), want, rtol=0, atol=1e-5 * np.sqrt(24) * np.abs(want).max())


@pytest.mark.parametrize("n", [4, 8])
def test_ring_cdist_matches_heat_tpu(ht, JO, monkeypatch, n):
    JQ = importlib.import_module("heat_tpu.core.quantize")
    jc, tc = _pair(ht, n)
    x_np, y_np = _rand((32, 6), 18), _rand((64, 6), 19)
    calls = []
    orig = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda *a, **kw: calls.append(tuple(a[1].shape)) or orig(*a, **kw))
    xb = htt.array(x_np, split=0, comm=tc, device="cpu")
    yb = htt.array(y_np, split=0, comm=tc, device="cpu")
    want = ht.spatial.cdist(ht.array(x_np, split=0, comm=jc), ht.array(y_np, split=0, comm=jc)).numpy()
    got = htt.spatial.cdist(xb, yb)
    # the ring layout stays eager, as heat_tpu's
    assert not isinstance(got, PF.LazyDNDarray)
    assert got.split == 0 and got.shape == (32, 64)
    # one K1 call a (position, rotating block) pair
    assert calls == [(64 // n, 6)] * (n * n)
    # K1 has no noise floor (ROADMAP's known difference): no pair coincides here
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with PF.fuse(False):
        gathered = htt.spatial.cdist(xb, htt.array(y_np, comm=tc, device="cpu")).numpy()
    np.testing.assert_allclose(got.numpy(), gathered, rtol=1e-6, atol=1e-6)
    # the quantized-corpus ring
    qa = JQ.quantize_weights(ht.array(y_np, split=0, comm=jc), "int8", axis=1)
    qb = TQ.quantize_weights(yb, "int8", axis=1)
    want = ht.spatial.distance.cdist_quantized(ht.array(x_np, split=0, comm=jc), qa).numpy()
    np.testing.assert_allclose(htt.spatial.cdist_quantized(xb, qb).numpy(), want, rtol=1e-4, atol=1e-4)


def test_ring_cdist_on_a_forced_wire_matches_the_quantized_corpus(monkeypatch):
    tc = htt.MeshComm(4)
    x_np, y_np = _rand((32, 6), 20), _rand((64, 6), 21)
    xb = htt.array(x_np, split=0, comm=tc, device="cpu")
    yb = htt.array(y_np, split=0, comm=tc, device="cpu")
    prev = htt.wire.set_mode("int8")
    monkeypatch.setenv("HEAT_TPU_WIRE_MIN_BYTES", "1")
    try:
        wired = htt.spatial.cdist(xb, yb).numpy()
    finally:
        htt.wire.set_mode(prev)
    want = htt.spatial.cdist_quantized(xb, TQ.quantize_weights(yb, "int8", axis=1)).numpy()
    np.testing.assert_array_equal(wired, want)


def test_tuned_wire_keeps_one_device_rings_exact(modes, monkeypatch):
    # every position on one device: no byte crosses a link, so under the
    # default tuned wire ("on") the ring GEMM and the ring cdist consult no
    # wire entry and stay bitwise the f32 ring; a forced mode still applies
    tc = htt.MeshComm(4)
    monkeypatch.setenv("HEAT_TPU_WIRE_MIN_BYTES", "1")
    a_np, b_np = _rand((32, 16), 22), _rand((16, 24), 23)
    x_np, y_np = _rand((32, 6), 24), _rand((64, 6), 25)
    ha, hb = htt.array(a_np, split=0, comm=tc, device="cpu"), htt.array(b_np, split=0, comm=tc, device="cpu")
    xb, yb = htt.array(x_np, split=0, comm=tc, device="cpu"), htt.array(y_np, split=0, comm=tc, device="cpu")
    PO.set_mode("ring")
    prev_w, prev_a = htt.wire.set_mode("off"), htt.autotune.set_enabled(True)
    try:
        exact_mm, exact_d = PO.matmul(ha, hb).numpy(), htt.spatial.cdist(xb, yb).numpy()
        htt.wire.set_mode("on")
        before, n_entries = htt.wire.stats(), htt.autotune.table_size()
        for _ in range(3):
            np.testing.assert_array_equal(PO.matmul(ha, hb).numpy(), exact_mm)
            np.testing.assert_array_equal(htt.spatial.cdist(xb, yb).numpy(), exact_d)
        after = htt.wire.stats()
        assert after["explores"] == before["explores"] and after["by_arm"] == before["by_arm"]
        assert htt.autotune.table_size() == n_entries
        htt.wire.set_mode("int8")
        assert not np.array_equal(PO.matmul(ha, hb).numpy(), exact_mm)
    finally:
        htt.wire.set_mode(prev_w)
        htt.autotune.set_enabled(prev_a)


@pytest.fixture
def port_mode():
    """Restores the port's dispatch mode and counters (the card tests run
    without the JAX package)."""
    yield
    PO.set_mode(None)
    PO.reset_stats()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs the card")
def test_ring_on_the_card_against_plain(port_mode):
    PO.set_mode("ring")
    tc = htt.MeshComm(4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(513, 300, generator=gen, device="cuda")
    b = torch.randn(300, 257, generator=gen, device="cuda")
    want = (a.double() @ b.double())
    bound = 1e-5 * (a.abs().double() @ b.abs().double())
    for sa, sb in ((0, 0), (1, 0), (1, 1)):
        with PF.fuse(False):
            got = htt.matmul(htt.array(a, split=sa, comm=tc), htt.array(b, split=sb, comm=tc))
        assert PO.stats()["last"]["schedule"].startswith("ring")
        assert bool(((got.larray.double() - want).abs() <= bound).all())
    # bf16 operands: tensor-core blocks with an f32 result, one rounding to
    # bf16 at the end (2^-8 of the value beside the f32 sums' bound)
    a16, b16 = a.bfloat16(), b.bfloat16()
    want16 = a16.double() @ b16.double()
    bound16 = 1e-5 * (a16.abs().double() @ b16.abs().double()) + 2.0**-8 * want16.abs()
    for sa, sb in ((0, 0), (1, 0), (1, 1)):
        with PF.fuse(False):
            got = htt.matmul(htt.array(a16, split=sa, comm=tc), htt.array(b16, split=sb, comm=tc))
        assert PO.stats()["last"]["schedule"].startswith("ring") and got.larray.dtype == torch.bfloat16
        assert bool(((got.larray.double() - want16).abs() <= bound16).all())
    k1.launches = 0
    x = htt.array(torch.randn(64, 16, generator=gen, device="cuda"), split=0, comm=tc)
    y = htt.array(torch.randn(128, 16, generator=gen, device="cuda"), split=0, comm=tc)
    d = htt.spatial.cdist(x, y)
    torch.cuda.synchronize()
    assert k1.launches == 16
    ref = k1.reference_cdist(x.larray, y.larray, sqrt=True)
    assert float((d.larray - ref).abs().max()) <= 1e-4
