"""Parity of heat_tpu_torch's weight quantization (``core/quantize.py``,
``spatial.cdist_quantized``, ``KNeighborsClassifier.quantize_``) with
heat_tpu's on the CPU (mirrors tests/test_quantize.py).

Tolerances: the grids are bitwise heat_tpu's (its jitted quantizer; the
f32 scale is ``absmax · f32(1/qmax)``), at meshes 1/4/8 and every split;
dequantized weights are bitwise equal.  The bf16 arm is bitwise the port's
ordinary matmul over the dequantized weight; products are held to
heat_tpu's within 1e-5 of the largest output times √k (f32 sums in other
orders over a contraction of length k).  Distances to a quantized corpus
agree to 1e-4 relative (K1's plain version against heat_tpu's expansion,
which floors self-distances to 0).  Labels are equal.  No test depends on
which arm wins by wall clock: arms are forced with ``arm=`` or the tables
are driven by ``observe``."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.analysis import sanitize as TS
from heat_tpu_torch.core import autotune as TA
from heat_tpu_torch.core import quantize as TQ
from heat_tpu_torch.core import telemetry as TT
from heat_tpu_torch.ops import cdist as k1

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JQ(ht):
    from heat_tpu.core import quantize

    return quantize


@pytest.fixture
def tuned():
    prev = TA.set_enabled(True)
    TA.reset()
    yield
    TA.set_enabled(prev)
    TA.reset()


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


# ------------------------------------------------------------ raw-tensor tier
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape, axis", [((16, 24), -1), ((16, 24), 0), ((8, 6, 10), (0, 2)), ((5, 7, 3), (1,))])
def test_quantize_tensor_is_heat_tpus_grid(JQ, dtype, shape, axis):
    import jax.numpy as jnp

    w = _rand(shape, 1, scale=3.0)
    w[0] = 0  # an all-zero channel round-trips exactly
    a, b = JQ.quantize_tensor(jnp.asarray(w), dtype, axis=axis), TQ.quantize_tensor(torch.from_numpy(w), dtype, axis=axis)
    assert a.axes == b.axes and a.orig_dtype == b.orig_dtype and a.shape == b.shape and a.ndim == b.ndim
    assert a.nbytes == b.nbytes
    np.testing.assert_array_equal(np.asarray(a.q).view(np.uint8), b.q.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale_broadcast()).shape, tuple(b.scale_broadcast().shape))
    np.testing.assert_array_equal(np.asarray(JQ.dequantize_tensor(a)), TQ.dequantize_tensor(b).numpy())
    with pytest.raises(ValueError, match="'int8' or 'fp8'"):
        TQ.quantize_tensor(torch.from_numpy(w), "int4")


def test_quantize_params_walks_targets(JQ):
    tree = {"blk": {"moe": {"w_in": torch.ones(2, 3, 4), "w_out": torch.ones(2, 4, 3), "gate": torch.ones(3, 2)}},
            "scale": torch.ones(3), "note": "x"}
    out = TQ.quantize_params(tree, "int8")
    assert isinstance(out["blk"]["moe"]["w_in"], TQ.QuantizedTensor) and out["blk"]["moe"]["w_in"].axes == (0, 2)
    assert out["blk"]["moe"]["gate"] is tree["blk"]["moe"]["gate"] and out["scale"] is tree["scale"]
    assert out["note"] == "x" and TQ.quantize_params(5) == 5


# ----------------------------------------------------------- DNDarray tier
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weights_per_shard(ht, JQ, n, split, axis):
    w = _rand((24, 10), 2 + axis, scale=2.0)
    jc, tc = _pair(ht, n)
    a = JQ.quantize_weights(ht.array(w, split=split, comm=jc), "int8", axis=axis)
    b = TQ.quantize_weights(htt.array(w, split=split, comm=tc, device="cpu"), "int8", axis=axis)
    assert (a.shape, a.ndim, a.split, a.axis, a.qdtype, a.dtype.__name__) == (
        b.shape, b.ndim, b.split, b.axis, b.qdtype, b.dtype.__name__)
    assert repr(a) == repr(b) and a.nbytes == b.nbytes
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    da, db = a.dequantize(), b.dequantize()
    assert da.split == db.split == split
    np.testing.assert_array_equal(da.numpy(), db.numpy())
    for x, y in zip(da.lshards(), db.lshards()):
        np.testing.assert_array_equal(np.asarray(x), y)
    ta, tb = a.T, b.T
    assert (ta.shape, ta.split, ta.axis) == (tb.shape, tb.split, tb.axis)
    np.testing.assert_array_equal(ta.dequantize().numpy(), tb.dequantize().numpy())


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("arm", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_matmul_quantized_both_arms(ht, JQ, n, arm, dtype):
    m, k, nn = 16, 24, 12
    x, w = _rand((m, k), 5), _rand((k, nn), 6)
    jc, tc = _pair(ht, n)
    for xs, ws in ((0, None), (None, 1), (0, 1)):
        qa = JQ.quantize_weights(ht.array(w, split=ws, comm=jc), dtype, axis=1)
        qb = TQ.quantize_weights(htt.array(w, split=ws, comm=tc, device="cpu"), dtype, axis=1)
        xa, xb = ht.array(x, split=xs, comm=jc), htt.array(x, split=xs, comm=tc, device="cpu")
        ya, yb = JQ.matmul_quantized(xa, qa, arm=arm), TQ.matmul_quantized(xb, qb, arm=arm)
        assert ya.split == yb.split and ya.shape == yb.shape and ya.dtype.__name__ == yb.dtype.__name__
        want = ya.numpy()
        np.testing.assert_allclose(yb.numpy(), want, rtol=0, atol=1e-5 * np.sqrt(k) * np.abs(want).max())
        if arm == "bf16":
            np.testing.assert_array_equal(yb.numpy(), htt.matmul(xb, qb.dequantize()).numpy())
        else:
            # the int8 arm: the low-precision operand widened, the product
            # scaled per column
            ref = (x.astype(np.float64) @ qb.q.to(torch.float64).numpy()) * qb.scale.double().numpy()
            np.testing.assert_allclose(yb.numpy(), ref, rtol=0, atol=1e-5 * np.sqrt(k) * np.abs(ref).max())


def test_linear_and_matmul_route_quantized_weights(ht, JQ):
    x, w, bias = _rand((8, 12), 7), _rand((6, 12), 8), _rand((6,), 9)
    jc, tc = _pair(ht, 4)
    qa = JQ.quantize_weights(ht.array(w, comm=jc), "int8", axis=0)
    qb = TQ.quantize_weights(htt.array(w, comm=tc, device="cpu"), "int8", axis=0)
    xb = htt.array(x, split=0, comm=tc, device="cpu")
    want = ht.nn.functional.linear(ht.array(x, split=0, comm=jc), qa, ht.array(bias, comm=jc)).numpy()
    got = htt.nn.functional.linear(xb, qb, htt.array(bias, comm=tc, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(htt.linalg.matmul(xb, qb.T).numpy(), TQ.matmul_quantized(xb, qb.T).numpy())
    with pytest.raises(ValueError, match="channel axis"):
        TQ.matmul_quantized(xb, qb)
    with pytest.raises(ValueError, match="out_features"):
        TQ.linear(xb, qb.T)
    with pytest.raises(ValueError, match="inner dimensions"):
        TQ.matmul_quantized(htt.array(_rand((8, 5), 1), device="cpu"), qb.T)
    with pytest.raises(ValueError, match="2-D only"):
        TQ.matmul_quantized(htt.array(_rand((2, 8, 12), 1), device="cpu"), qb.T)


# ------------------------------------------------------------ arm dispatch
def test_tuned_arm_explores_serves_and_forces(tuned):
    x, w = _rand((16, 24), 10), _rand((24, 8), 11)
    tc = htt.MeshComm(4)
    xb = htt.array(x, split=0, comm=tc, device="cpu")
    qb = TQ.quantize_weights(htt.array(w, comm=tc, device="cpu"), "int8", axis=1)
    bf16 = TQ.matmul_quantized(xb, qb, arm="bf16").numpy()
    int8 = TQ.matmul_quantized(xb, qb, arm="int8").numpy()
    with pytest.raises(ValueError, match="arm must be one of"):
        TQ.matmul_quantized(xb, qb, arm="fp16")
    # explore: both arms run, the bf16 result is returned bitwise
    for _ in range(TA.explore_k()):
        np.testing.assert_array_equal(TQ.matmul_quantized(xb, qb).numpy(), bf16)
    (key,) = TA.table()
    assert all(len(d) == TA.explore_k() for d in TA.table()[key]["arms"].values())
    # a table that names int8 serves it alone
    TA.reset()
    TA.decide(key, "bf16", arms=TA.QUANT_ARMS)
    for _ in range(TA.explore_k()):
        TA.observe(key, "bf16", 1.0)
        TA.observe(key, "int8", 0.1)
    np.testing.assert_array_equal(TQ.matmul_quantized(xb, qb).numpy(), int8)
    # the plane off: bf16, no table decision
    TA.set_enabled(False)
    TA.reset()
    np.testing.assert_array_equal(TQ.matmul_quantized(xb, qb).numpy(), bf16)
    assert TA.table() == {}


def test_a_raising_int8_arm_raises(tuned):
    """No rescue: heat_tpu charges a raising int8 arm infinity while
    exploring and serves bf16 in its place; the port raises."""
    calls = []

    def boom():
        raise RuntimeError("int8 arm failed")

    before = TQ.stats()["int8_fallbacks"]
    with pytest.raises(RuntimeError, match="int8 arm failed"):
        TQ.tuned_arm("probe", (1,), lambda: calls.append(1), boom)
    key = TA.quant_key("probe", 1)
    TA.reset()
    TA.decide(key, "bf16", arms=TA.QUANT_ARMS)
    for _ in range(TA.explore_k()):
        TA.observe(key, "bf16", 1.0)
        TA.observe(key, "int8", 0.1)
    with pytest.raises(RuntimeError, match="int8 arm failed"):
        TQ.tuned_arm("probe", (1,), lambda: calls.append(1), boom)
    assert TQ.stats()["int8_fallbacks"] == before and calls == [1]


def test_autograd_takes_the_reference_arm_untimed(tuned):
    tc = htt.MeshComm(4)
    x = torch.from_numpy(_rand((16, 24), 12)).requires_grad_()
    xb = htt.DNDarray(list(x.chunk(4)), (16, 24), htt.float32, 0, htt.cpu, tc)
    qb = TQ.quantize_weights(htt.array(_rand((24, 8), 13), comm=tc, device="cpu"), "int8", axis=1)
    before = TQ.stats()["declines"]
    y = TQ.matmul_quantized(xb, qb)
    assert TA.table() == {} and TQ.stats()["declines"] == before + 1
    y.larray.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.broadcast_to(qb.dequantize().numpy().sum(1), (16, 24)), rtol=1e-5)
    with torch.no_grad():
        TQ.matmul_quantized(xb, qb)
    assert len(TA.table()) == 1


# --------------------------------------------------- residency and donation
def test_residency_and_donation_with_the_sanitizer(ht, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_SANITIZE", "1")
    prev = TT.set_level("events")
    TS.reset()
    try:
        tc = htt.MeshComm(4)
        w = htt.array(_rand((64, 32), 14), split=0, comm=tc, device="cpu")
        master = w.shards
        qw = TQ.quantize_weights(w, "int8", axis=1, donate=True)
        by_dtype = htt.memtrack.census()["bytes_by_dtype"]
        assert by_dtype["torch.int8"] >= 64 * 32 and 64 * 32 * 4 / qw.nbytes >= 3
        tags = {r["tag"] for r in htt.memtrack.live_buffers(top=None) if r["shape"] == (16, 32)
                and r["dtype"] == "torch.float32"}
        assert "donated" in tags and TQ.stats()["donated"] >= 1
        entry = TS.poison_entry(master[0])
        assert entry["donated"] == "quantize.quantize_weights(donate=True)" and entry["nbytes"] == 16 * 32 * 4
        # the transport entries refuse the donated master
        with pytest.raises(htt.analysis.UseAfterDonateError if hasattr(htt, "analysis") else TS.UseAfterDonateError,
                           match="tiled_resplit"):
            htt.resplit(w, 1)
        with pytest.raises(TS.UseAfterDonateError, match="tiled_reshape"):
            htt.reshape(w, (32, 64), new_split=1)
        # a quantized KNN corpus drops its master
        y = htt.array(np.arange(64) % 3, split=0, comm=tc, device="cpu")
        knn = htt.classification.KNeighborsClassifier(3).fit(htt.array(_rand((64, 32), 15), split=0, comm=tc,
                                                                       device="cpu"), y)
        corpus = knn.x.shards
        knn.quantize_("int8", donate=True)
        assert knn.x is None and TS.poison_entry(corpus[1]) is not None
    finally:
        TT.set_level(prev)
        TS.reset()


# -------------------------------------------------------- quantized corpus
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_cdist_quantized_matches_heat_tpu_through_k1(ht, JQ, monkeypatch, n, dtype):
    from heat_tpu.spatial import distance as JD

    jc, tc = _pair(ht, n)
    y, x = _rand((64, 16), 16), _rand((32, 16), 17)
    qa = JQ.quantize_weights(ht.array(y, split=0, comm=jc), dtype, axis=1)
    qb = TQ.quantize_weights(htt.array(y, split=0, comm=tc, device="cpu"), dtype, axis=1)
    calls = []
    orig = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda *a, **kw: calls.append(a[1].shape) or orig(*a, **kw))
    want = JD.cdist_quantized(ht.array(x, split=0, comm=jc), qa).numpy()
    got = htt.spatial.cdist_quantized(htt.array(x, split=0, comm=tc, device="cpu"), qb)
    assert got.split == 0 and got.shape == (32, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # one K1 call a (position, rotating block) pair
    assert calls == [(64 // n, 16)] * (n * n)
    deq = htt.spatial.cdist(htt.array(x, split=0, comm=tc, device="cpu"), qb.dequantize())
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5, atol=1e-5)


def test_cdist_quantized_none_and_errors(ht):
    tc = htt.MeshComm(4)
    y = htt.array(_rand((64, 16), 18), split=0, comm=tc, device="cpu")
    qb = TQ.quantize_weights(y, "int8", axis=1)
    x = _rand((32, 16), 19)
    # the ring's layout does not fit: one position, replicated queries,
    # rows that do not divide
    one = TQ.quantize_weights(htt.array(y.numpy(), split=0, comm=htt.MeshComm(1), device="cpu"), "int8", axis=1)
    assert htt.spatial.cdist_quantized(htt.array(x, split=0, comm=htt.MeshComm(1), device="cpu"), one) is None
    assert htt.spatial.cdist_quantized(htt.array(x, comm=tc, device="cpu"), qb) is None
    assert htt.spatial.cdist_quantized(htt.array(x[:13], split=0, comm=tc, device="cpu"), qb) is None
    with pytest.raises(ValueError, match="per-feature scales"):
        htt.spatial.cdist_quantized(htt.array(x, split=0, comm=tc, device="cpu"), TQ.quantize_weights(y, axis=0))
    with pytest.raises(ValueError, match="feature dims disagree"):
        htt.spatial.cdist_quantized(htt.array(x[:, :8], split=0, comm=tc, device="cpu"), qb)


@pytest.mark.parametrize("n", MESHES)
def test_knn_quantize_predict_matches_heat_tpu(ht, n):
    jc, tc = _pair(ht, n)
    corpus, labels = _rand((64, 16), 20), np.random.default_rng(21).integers(0, 3, 64)
    out = []
    for pkg, comm, kw in ((ht, jc, {}), (htt, tc, {"device": "cpu"})):
        clf = pkg.classification.KNeighborsClassifier(n_neighbors=3)
        clf.fit(pkg.array(corpus, split=0, comm=comm, **kw), pkg.array(labels, split=0, comm=comm, **kw))
        clf.quantize_("int8")
        assert clf.x is None
        preds = [clf.predict(pkg.array(_rand((m, 16), 22), split=0, comm=comm, **kw)).numpy() for m in (16, 13)]
        out.append((preds, clf))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    # the labels of the f32 predict against the dequantized corpus
    clf = out[1][1]
    ref = htt.classification.KNeighborsClassifier(n_neighbors=3)
    ref.fit(clf._qx.dequantize(), htt.array(labels, split=0, comm=tc, device="cpu"))
    np.testing.assert_array_equal(ref.predict(htt.array(_rand((16, 16), 22), split=0, comm=tc, device="cpu")).numpy(),
                                  out[1][0][0])


def test_knn_quantize_errors():
    clf = htt.classification.KNeighborsClassifier(n_neighbors=3)
    with pytest.raises(RuntimeError, match="fit the model first"):
        clf.quantize_()
    x = htt.array(_rand((16, 4), 23), split=0, device="cpu")
    y = htt.array(np.arange(16) % 2, split=0, device="cpu")
    clf.fit(x, y).quantize_()
    with pytest.raises(RuntimeError, match="already quantized"):
        clf.quantize_()
    l1 = htt.classification.KNeighborsClassifier(3, effective_metric_=htt.spatial.manhattan).fit(x, y)
    with pytest.raises(ValueError, match="euclidean"):
        l1.quantize_()
