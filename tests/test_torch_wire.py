"""Parity of heat_tpu_torch's wire formats (``core/wire.py`` and the
transport engine's quantized resplit and rechunk) with heat_tpu's on the
CPU (mirrors tests/test_wire.py).

The encode is held to heat_tpu's as its jitted programs compute it (XLA
folds ``absmax / qmax`` into a multiplication by the f32 reciprocal):
bitwise, for int8 and fp8, over several kept axes, all-zero rows included,
and the f32 → e4m3fn cast over a sweep of f32 bit patterns.  A resplit and
a split-crossing reshape under a forced ``int8``/``fp8`` wire equal
heat_tpu's per shard, bitwise, at meshes 1/4/8 and at sizes below and above
one tile (``TILE_BYTES`` set alike in both packages); ``off`` and
``exact=True`` are bitwise the input.  No test depends on which arm wins by
wall clock: arms are forced, or the tables are driven by ``observe``."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import autotune as TA
from heat_tpu_torch.core import telemetry as TT
from heat_tpu_torch.core import wire as TW
from heat_tpu_torch.parallel import transport as TP

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JW(ht):
    from heat_tpu.core import wire

    return wire


@pytest.fixture
def wired(ht, JW, monkeypatch):
    """Both wire planes at a 1-byte threshold, restored afterwards; yields
    a function that forces one mode in both."""
    from heat_tpu.core import autotune as JA
    from heat_tpu.core import telemetry as JT

    monkeypatch.setenv("HEAT_TPU_WIRE_MIN_BYTES", "1")
    prev = (TW.set_mode(None), JW.set_mode(None), TA.set_enabled(None), JA.set_enabled(None))
    for mod in (TT, JT):
        mod.reset_all()
    TA.reset()
    JA.reset()

    def force(mode):
        TW.set_mode(mode)
        JW.set_mode(mode)

    yield force
    TW.set_mode(prev[0])
    JW.set_mode(prev[1])
    TA.set_enabled(prev[2])
    JA.set_enabled(prev[3])
    TA.reset()
    JA.reset()
    for mod in (TT, JT):
        mod.reset_all()


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * np.exp(2 * rng.standard_normal(shape))).astype(np.float32)
    a.reshape(shape[0], -1)[0] = 0  # an all-zero row
    return a


# ------------------------------------------------------------------ grid math
ENCODES = [((64, 33), (0,)), ((64, 33), ()), ((64, 33), (1,)), ((8, 5, 7), (0, 2)), ((8, 5, 7), (0, 1)),
           ((6, 4, 3, 5), (1,))]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape, axes", ENCODES)
def test_encode_decode_bitwise_heat_tpus(JW, mode, shape, axes):
    import jax
    import jax.numpy as jnp

    a = _data(shape, seed=len(shape) + len(axes))
    qj, sj = jax.jit(lambda x: JW.absmax_encode(x, mode, axes))(jnp.asarray(a))
    qt, st = TW.absmax_encode(torch.from_numpy(a), mode, axes)
    assert qt.dtype == TW.qdtype(mode) and st.dtype == torch.float32
    np.testing.assert_array_equal(_bits(sj), _bits(st.numpy()))
    np.testing.assert_array_equal(_bits(qj), _bits(qt.view(torch.uint8).numpy()))
    dj = jax.jit(lambda q, s: JW.absmax_decode(q, s, axes, jnp.float32))(qj, sj)
    dt = TW.absmax_decode(qt, st, axes, torch.float32)
    np.testing.assert_array_equal(_bits(dj), _bits(dt.numpy()))
    # all-zero rows carry scale 1 and arrive as exact zeros
    if axes == (0,):
        assert float(st[0]) == 1.0 and not dt[0].any()


def test_rounding_and_fp8_cast_over_a_bit_pattern_sweep():
    import jax.numpy as jnp
    import ml_dtypes

    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.4999998], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.round(halves)), torch.round(torch.from_numpy(halves)).numpy())
    bits = (np.arange(0, 1 << 32, 4099, dtype=np.uint64)).astype(np.uint32)
    f = bits.view(np.float32)
    f = np.clip(f[np.isfinite(f)], -448.0, 448.0)
    want = np.asarray(jnp.asarray(f).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = torch.from_numpy(f).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, f.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


def test_mode_knobs_and_payload_model(JW, monkeypatch):
    for mod in (TW, JW):
        prev = mod.set_mode(None)
        assert mod.mode(env={}) == "on" and mod.mode(env={"HEAT_TPU_WIRE": " FP8 "}) == "fp8"
        with pytest.raises(ValueError, match="HEAT_TPU_WIRE"):
            mod.mode(env={"HEAT_TPU_WIRE": "int4"})
        with pytest.raises(ValueError, match="mode must be one of"):
            mod.set_mode("bf16")
        assert mod.min_bytes(env={}) == 64 << 10 and mod.min_bytes(env={"HEAT_TPU_WIRE_MIN_BYTES": "8"}) == 8
        with pytest.raises(ValueError, match="HEAT_TPU_WIRE_MIN_BYTES"):
            mod.min_bytes(env={"HEAT_TPU_WIRE_MIN_BYTES": "0"})
        assert mod.payload_nbytes(1000, 10, "int8") == 1040 and mod.QMAX == {"int8": 127.0, "fp8": 448.0}
        assert mod.fp8_available()
        with pytest.raises(ValueError, match="'int8' or 'fp8'"):
            mod.qdtype("int4")
        mod.set_mode(prev)
    assert set(TW.stats()) == set(JW.stats())


def test_eligible_choose_consume_decline(ht, JW, wired, monkeypatch):
    import jax.numpy as jnp
    from heat_tpu.core import autotune as JA

    monkeypatch.setenv("HEAT_TPU_WIRE_MIN_BYTES", str(64 << 10))
    cases = [("float32", 1 << 20, False), ("float32", 1 << 20, True), ("int32", 1 << 20, False),
             ("bool", 1 << 20, False), ("float32", 100, False), ("bfloat16", 1 << 20, False),
             ("float64", 1 << 20, False), ("float8_e4m3fn", 1 << 20, False), ("complex64", 1 << 20, False)]
    out = []
    for mode in ("on", "off", "int8", "fp8"):
        wired(mode)
        for autotune_on in (False, True):
            TA.set_enabled(autotune_on)
            JA.set_enabled(autotune_on)
            row = []
            for mod, conv, auto in ((TW, lambda n: getattr(torch, n), TA), (JW, lambda n: jnp.dtype(n), JA)):
                got = [mod.eligible(conv(dt), nb, exact=ex) for dt, nb, ex in cases]
                arm, d = mod.choose("resplit", ((4, 4), 0, 1, 4, "float32"))
                mod.decline("take")
                row.append((got, arm, None if d is None else (d.arm, d.source, d.explore),
                            mod.consume("resplit", ((8, 8), 0, 1, 4, "float32")),
                            mod.stats()["declined_static"], auto.stats()["priors"], auto.stats()["explores"]))
            out.append(row)
    for t, j in out:
        assert t == j
    assert [r[0][0] for r in out][::2] == [[True, False, False, False, False, True, True, False, False],
                                           [False] * 9, [True, False, False, False, False, True, True, False, False],
                                           [True, False, False, False, False, True, True, False, False]]


# ---------------------------------------------------------- forced transport
TRANSPORT = [
    ((37, 29), 0, 1, (29, 37), 1),
    ((16, 6, 5), 1, 0, (48, 10), 1),
    ((40, 12), 1, 0, (24, 20), 0),
    ((30, 8), 0, 1, (20, 12), 1),
    ((24, 16), 0, 1, (48, 8), 0),
]


def _shards_equal(a, b):
    sa, sb = a.lshards(), b.lshards()
    assert a.split == b.split and len(sa) == len(sb)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("tile_bytes", [8 << 20, 2048], ids=["one-tile", "many-tiles"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("n", MESHES)
def test_forced_resplit_and_reshape_equal_heat_tpus_per_shard(ht, wired, monkeypatch, n, mode, tile_bytes):
    from heat_tpu.parallel import transport as JP

    monkeypatch.setattr(JP, "TILE_BYTES", tile_bytes)
    monkeypatch.setattr(TP, "TILE_BYTES", tile_bytes)
    wired(mode)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    rel = 0.0
    for i, (shape, sa, sb, gout, so) in enumerate(TRANSPORT):
        a = _data(shape, seed=i)
        xj, xt = ht.array(a, split=sa, comm=jc), htt.array(a, split=sa, comm=tc, device="cpu")
        rj, rt = ht.resplit(xj, sb), htt.resplit(xt, sb)
        _shards_equal(rj, rt)
        qj, qt = ht.reshape(xj, gout, new_split=so), htt.reshape(xt, gout, new_split=so)
        _shards_equal(qj, qt)
        rel = max(rel, float(np.abs(rt.numpy() - a).max() / np.abs(a).max()))
    # a lossy wire (n > 1), within its grid's step of the block's absmax
    assert (rel > 0) == (n > 1) and rel <= (1 / 127 if mode == "int8" else 1 / 8)
    assert TW.stats() == ht.wire.stats()
    if n > 1:
        assert TW.stats()["by_arm"]["wire_" + mode] > 0 and TW.stats()["bytes_wire"] < TW.stats()["bytes_logical"]


@pytest.mark.parametrize("n", [4, 8])
def test_off_and_exact_are_bitwise(ht, wired, n):
    from heat_tpu.parallel import transport as JP

    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = _data((40, 24), seed=9)
    for mode in ("off", "int8"):
        wired(mode)
        xt = htt.array(a, split=0, comm=tc, device="cpu")
        got = TP.tiled_resplit(xt.shards, a.shape, 0, 1, tc, exact=True)
        np.testing.assert_array_equal(_bits(torch.cat(got, dim=1).numpy()), _bits(a))
        z = TP.tiled_reshape(xt.shards, a.shape, 0, (24, 40), 1, tc, exact=True)
        np.testing.assert_array_equal(_bits(torch.cat(z, dim=1).numpy()), _bits(a.reshape(24, 40)))
        xj = ht.array(a, split=0, comm=jc)
        pj = JP.tiled_resplit(xj.parray, a.shape, 0, 1, jc, exact=True)
        np.testing.assert_array_equal(_bits(np.asarray(pj)[:, :24]), _bits(a))
    wired("off")
    xt = htt.array(a, split=0, comm=tc, device="cpu")
    np.testing.assert_array_equal(_bits(htt.resplit(xt, 1).numpy()), _bits(a))
    assert TW.stats()["quantized_dispatches"] == 0


def test_take_declines_and_counters(ht, wired):
    wired("int8")
    tc = htt.MeshComm(4)
    a = _data((40, 8), seed=4)
    x = htt.array(a, split=0, comm=tc, device="cpu")
    rows = np.array([39, 0, 7, 7, 21])
    np.testing.assert_array_equal(_bits(x[rows].numpy()), _bits(a[rows]))
    assert TW.stats()["declined_static"] == 1 and TW.stats()["quantized_dispatches"] == 0


# ---------------------------------------------------------------- tuned wire
def test_explore_returns_f32_then_the_table_serves(ht, wired):
    """Under ``on``: the explore calls return the f32 result bitwise; once
    the table names an int8 winner (driven by ``observe``) the resplit
    equals the forced int8 one, and the sampled observer keeps the watch."""
    wired("on")
    TA.set_enabled(True)
    tc = htt.MeshComm(4)
    a = _data((48, 40), seed=5)
    x = htt.array(a, split=0, comm=tc, device="cpu")
    for _ in range(TA.explore_k()):
        np.testing.assert_array_equal(_bits(htt.resplit(x, 1).numpy()), _bits(a))
    (key,) = list(TA.table())
    assert TA.table()[key]["winner"] is not None and TW.stats()["explores"] == TA.explore_k()
    assert all(len(d) == TA.explore_k() for d in TA.table()[key]["arms"].values())
    TA.reset()
    TA.decide(key, "wire_f32", arms=TA.WIRE_ARMS)
    for _ in range(TA.explore_k()):
        for arm, dur in (("wire_f32", 1.0), ("wire_int8", 0.1), ("wire_fp8", 0.5)):
            TA.observe(key, arm, dur)
    tuned = htt.resplit(x, 1).numpy()
    wired("int8")
    np.testing.assert_array_equal(_bits(tuned), _bits(htt.resplit(x, 1).numpy()))
    assert TW.stats()["by_arm"]["wire_int8"] == 2


def test_prometheus_wire_gauges(ht, wired):
    wired("int8")
    prev = TT.set_level("counters")
    try:
        TT.reset_programs()
        x = htt.array(_data((256, 64)), split=0, comm=htt.MeshComm(4), device="cpu")
        htt.resplit(x, 1)
        text = TT.export_prometheus()
        assert 'heat_tpu_wire_program_bytes{fingerprint="' in text and 'arm="int8"' in text
        assert "heat_tpu_wire_program_ratio" in text and "heat_tpu_wire_bytes_logical" in text
        (row,) = [p for p in TT.programs() if p.get("wire")]
        # 1-byte elements and one f32 scale a (row, destination, tile)
        assert row["logical_bytes"] == 256 * 64 * 4 and row["wire_bytes"] == 256 * 64 + 64 * 4 * 1 * 4 * 4
        assert row["logical_bytes"] / row["wire_bytes"] >= 3
    finally:
        TT.set_level(prev)
        TT.reset_programs()
