"""``heat_tpu_torch.core.fusion`` against heat_tpu's engine on the CPU.

The same numpy inputs go through both packages at meshes 1, 4 and 8: the
program cache's counts (misses, hits, ``cse_hits``, ``roots_per_program``)
for one call sequence, the fused values against the port's eager values
(bitwise) and heat_tpu's (within float32 rounding), ``describe``, scalars
as program inputs, the pins and the in-place write guard, the fused split
tail (values and declines, with heat_tpu's ``fused_tails`` counts), and the
KMeans assignment step through K1's plain version.  The mirror is
``tests/test_fusion.py``.
"""

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.core import fusion as PF
from heat_tpu_torch.ops import cdist as k1
from heat_tpu_torch.parallel import transport as PT

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _pair(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


def _counts(F):
    s = F.cache_stats()
    return (s["misses"], s["hits"], s["cse_hits"], dict(s["roots_per_program"]), s["size"])


def _sequence(H, F, comm, src, **dev):
    """heat_tpu's test_fusion.py call sequence, the counts after each step."""
    rows = []

    def arr(v, split=0):
        return H.array(v, split=split, comm=comm, **dev)

    F.reset_cache()
    x = arr(src)
    y = (x - 3.0) * 2.0
    rows.append(("lazy", isinstance(y, F.LazyDNDarray)) + _counts(F))
    vals = [np.asarray(y.numpy())]
    rows.append(("first",) + _counts(F))
    z = arr(src)
    vals.append(np.asarray(((z - 3.0) * 2.0).numpy()))
    rows.append(("same chain, new array",) + _counts(F))
    vals.append(np.asarray(((x - 7.25) * 0.5).numpy()))
    rows.append(("other scalars",) + _counts(F))
    vals.append(float(((x - x.mean()) ** 2).sum().item()))
    rows.append(("reduction",) + _counts(F))
    vals.append(np.asarray((x + 0.6).astype(H.int32).numpy()))
    rows.append(("astype",) + _counts(F))
    w = (x - 1.0) * 0.5
    m, v = w.mean(), w.var()
    H.materialize(m, v)
    vals += [float(m.item()), float(v.item())]
    rows.append(("mean+var",) + _counts(F))
    w2 = (arr(src) - 1.0) * 0.5
    H.materialize(w2.mean(), w2.var())
    rows.append(("mean+var again",) + _counts(F))
    a, b = (x * x).sum(), (x * x).mean()
    H.materialize(a, b)
    vals += [float(a.item()), float(b.item())]
    rows.append(("structural cse",) + _counts(F))
    mask = arr(src > 0.0)
    vals.append(np.asarray(H.add(x, arr(src[::-1].copy()), where=mask).numpy()))
    rows.append(("where",) + _counts(F))
    vals.append(bool(H.all(x > -100.0)))
    rows.append(("bool",) + _counts(F))
    vals.append(np.asarray(H.exp(H.sqrt(H.abs(x)) * -1.0).cumsum(0).numpy()))
    rows.append(("unary+scan",) + _counts(F))
    return rows, vals


@pytest.mark.parametrize("n", MESHES)
def test_cache_counts_and_values_match_heat_tpu(ht, n):
    from heat_tpu.core import fusion as JF

    jc, tc = _pair(ht, n)
    src = np.linspace(-2.0, 5.0, 3 * n + 5, dtype=np.float32)
    want, jvals = _sequence(ht, JF, jc, src)
    got, tvals = _sequence(htt, PF, tc, src, device="cpu")
    assert got == want
    with PF.fuse(False):
        _, evals = _sequence(htt, PF, tc, src, device="cpu")
    for t, e, j in zip(tvals, evals, jvals):
        np.testing.assert_array_equal(t, e)  # bitwise the port's eager values
        np.testing.assert_allclose(t, j, rtol=2e-6, atol=2e-6)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


CHAINS = {
    "mixed splits": lambda A, B, M, H: (A * B + 1.0) / (B - 0.5),
    "broadcast row": lambda A, B, M, H: A / B[0],
    "where": lambda A, B, M, H: H.add(A, B, where=M),
    "where into chain": lambda A, B, M, H: H.exp(H.mul(A, 2.0, where=M)) - 1.0,
    "int unary": lambda A, B, M, H: H.sqrt(H.abs(A).astype(H.int32)),
    "compare": lambda A, B, M, H: H.logical_and(A > B, A <= 1.0),
    "reductions": lambda A, B, M, H: (A * B).sum(axis=0) + A.max(axis=0) - B.min(axis=0),
    "argmin": lambda A, B, M, H: H.argmin(A - B, axis=1),
    "moments": lambda A, B, M, H: H.var(A, axis=0) + H.std(B, axis=0) + H.skew(A, axis=0),
    "mean keepdims": lambda A, B, M, H: A - H.mean(A, axis=1, keepdims=True),
    "cumsum": lambda A, B, M, H: H.cumsum(A * B, axis=0),
    "cdist": lambda A, B, M, H: H.spatial.cdist(A, B),
    "rbf": lambda A, B, M, H: H.spatial.rbf(A, B, sigma=1.3),
}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("splits", [(0, None), (1, 0), (None, 1)])
def test_fused_values_are_the_eager_values(ht, n, splits):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((12, 8)).astype(np.float32)
    B = (rng.standard_normal((12, 8)) + 2.0).astype(np.float32)
    M = A > 0.0
    jc, tc = _pair(ht, n)
    for name, chain in CHAINS.items():
        outs = []
        for fused in (True, False):
            with PF.fuse(fused):
                a = htt.array(A, split=splits[0], comm=tc, device="cpu")
                b = htt.array(B, split=splits[1], comm=tc, device="cpu")
                m = htt.array(M, split=splits[0], comm=tc, device="cpu")
                r = chain(a, b, m, htt)
                assert isinstance(r, PF.LazyDNDarray) == fused or name == "cdist", name
                outs.append((r.split, r.shape, r.numpy()))
        assert outs[0][:2] == outs[1][:2], name
        _eq(outs[0][2], outs[1][2])
        j = chain(ht.array(A, split=splits[0], comm=jc), ht.array(B, split=splits[1], comm=jc),
                  ht.array(M, split=splits[0], comm=jc), ht)
        assert j.split == outs[0][0] and tuple(j.shape) == outs[0][1], name
        np.testing.assert_allclose(outs[0][2], np.asarray(j.larray), rtol=1e-5, atol=1e-5, err_msg=name)


def test_describe_marks_shared_subtrees_as_heat_tpu_does(ht):
    texts = []
    for H, dev in ((ht, {}), (htt, {"device": "cpu"})):
        x = H.arange(12, dtype=H.float32, split=0, **dev)
        y = (x - 3.0) * 2.0
        text = H.fusion.describe(y.mean(), y.var())
        single = H.fusion.describe((x + 1.0) * 2.0)
        texts.append((text.count("mul("), text.count("<<shared x2>>"), text.strip().splitlines()[-1],
                      "<<shared" in single, single.strip().splitlines()[-1]))
    assert texts[0] == texts[1]
    y = htt.arange(4, dtype=htt.float32, split=0, device="cpu") + 1.0
    assert y.numpy().tolist() == [1.0, 2.0, 3.0, 4.0]
    assert PF.last_hlo().splitlines()[-1] == "return %2"


def test_switch_and_materialize_contracts():
    x = htt.arange(6, dtype=htt.float32, split=0, device="cpu")
    with PF.fuse(False):
        e = x * 2.0
        assert type(e) is htt.DNDarray
    y = x + 1.0
    assert PF.materialize(y) is y and "_DNDarray__shards" in y.__dict__
    got = htt.materialize(y, e, x + 2.0)
    assert len(got) == 3 and got[1] is e
    with pytest.raises(TypeError):
        htt.materialize()
    assert htt.materialize_all is PF.materialize_all and htt.fusion is PF
    assert PF.enabled() and PF._env_enabled()


def test_scalars_are_inputs_not_constants():
    PF.reset_cache()
    x = htt.arange(16, dtype=htt.float32, split=0, comm=htt.MeshComm(4), device="cpu")
    ((x + 1.5) * 2.0).numpy()
    out = ((x + 7.25) * 0.5).numpy()
    s = PF.cache_stats()
    assert (s["misses"], s["hits"]) == (1, 1)
    _eq(out, (np.arange(16, dtype=np.float32) + 7.25) * 0.5)


@pytest.mark.parametrize("n", MESHES)
def test_pins_guard_resplit_and_in_place_writes(n):
    src = np.arange(8 * n, dtype=np.float32)
    x = htt.array(src, split=0, comm=htt.MeshComm(n), device="cpu")
    y = x * 3.0  # pending: x's shards are pinned
    assert not PF.safe_to_donate(x.shards) and not PF.safe_to_donate(x)
    x.resplit_(None)
    _eq(y.numpy(), src * 3.0)
    seen = []
    for fused in (True, False):
        with PF.fuse(fused):
            v = htt.array(src, split=0, comm=htt.MeshComm(n), device="cpu")
            w = v * 2.0 + 1.0
            part = v[1:4]  # a view of v's shards where the port keeps one
            v[0] = 100.0
            part[0] = -5.0
            _eq(w.numpy(), src * 2.0 + 1.0)  # the values the chain was built on
            seen.append(v.numpy())
    _eq(seen[0], seen[1])
    assert seen[0][0] == 100.0
    del y, w
    assert PF.pin_leaks() == []


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("n", MESHES)
def test_writes_through_aliases_do_not_reach_pending_chains(n, fused):
    """A chain keeps the values its leaves had when it was built, whatever
    route the later write takes: the tensor ``.larray``, ``.shards`` or
    ``lloc`` handed out (before or after the chain was built), the
    caller's tensor behind ``array(copy=False)``, a torch or numpy
    operand.  The fused values are the eager ones."""
    import torch

    comm = htt.MeshComm(n)
    src = np.arange(4 * n, dtype=np.float32)
    with PF.fuse(fused):
        x = htt.array(src, comm=comm, device="cpu")  # replicated: .larray is the shard
        y = x * 2.0
        x.larray[0] = 50.0
        _eq(y.numpy(), src * 2.0)
        held = x.larray  # handed out before the next chain
        y = x + 1.0
        held[1] = -7.0
        want = src.copy()
        want[0] = 50.0
        _eq(y.numpy(), want + 1.0)

        t = torch.from_numpy(src.copy())
        a = htt.array(t, split=0, comm=comm, copy=False, device="cpu")
        y = a * 3.0
        t.add_(1.0)
        _eq(y.numpy(), src * 3.0)
        _eq(a.numpy(), src + 1.0)  # the alias itself sees the write
        y = a - 1.0
        a.shards[-1][-1] = 1000.0
        _eq(y.numpy(), src)
        before = a.numpy()
        y = a * 0.5
        row = a.lloc[0:2]
        row[0] = -1.0
        _eq(y.numpy(), before * 0.5)

        op_t = torch.ones(4 * n)
        op_n = np.ones(4 * n, dtype=np.float32)
        y1, y2 = x + op_t, x * op_n
        op_t.mul_(5.0)
        op_n[:] = 9.0
        want[1] = -7.0
        _eq(y1.numpy(), want + 1.0)
        _eq(y2.numpy(), want)


def test_a_write_the_engine_cannot_see_is_refused():
    """A write that reaches a leaf's tensor by a route around the package
    bumps its version counter: the materialization raises instead of
    reading the new values."""
    x = htt.array(np.arange(8, dtype=np.float32), split=0, comm=htt.MeshComm(2), device="cpu")
    y = x * 2.0
    x._DNDarray__shards[0].add_(1.0)
    with pytest.raises(RuntimeError, match="written in place after the chain was built"):
        y.numpy()


def test_exposed_storage_is_snapshot_outside_sealed_calls(monkeypatch):
    """A leaf over the caller's tensor is a copy, except in a library call
    that materializes its chain before it returns: KMeans on ``copy=False``
    data copies nothing."""
    import torch

    t = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    a = htt.array(t, split=0, comm=htt.MeshComm(4), copy=False, device="cpu")
    assert PF.leaf_from(a).value._DNDarray__shards[0].data_ptr() != t.data_ptr()
    with PF.sealed():
        assert PF.leaf_from(a).value._DNDarray__shards[0].data_ptr() == t.data_ptr()
    copies = []
    orig = PF._cloned
    monkeypatch.setattr(PF, "_cloned", lambda shards: copies.append(len(shards)) or orig(shards))
    km = htt.cluster.KMeans(n_clusters=3, init="random", max_iter=3, random_state=1).fit(a)
    km.predict(a)
    assert copies == []


def test_pinned_buffers_show_in_memtrack():
    from heat_tpu_torch.core import memtrack, telemetry

    with telemetry.telemetry_level("events"):
        memtrack.reset()
        x = htt.ones((64, 4), split=0, device="cpu")
        y = x + 1.0
        rows = memtrack.live_buffers(top=None)
        assert any(r["tag"] == "pinned" for r in rows)
        assert any(r.get("pinned") for r in rows)
        y.numpy()
        assert memtrack.leaks() == []


TAILS = {
    "chain": (lambda X, H: H.exp(X * 0.1) - 1.0, True),
    "sqrt": (lambda X, H: H.sqrt(X * X + 1.0), True),
    "compare": (lambda X, H: (X * 2.0) > 0.5, True),
    "reduction": (lambda X, H: (X * 2.0).sum(axis=1, keepdims=True), False),
    "where": (lambda X, H: H.add(X, 1.0, where=X > 0.0), False),
}


@pytest.mark.parametrize("n", MESHES)
def test_split_tail_values_and_declines(ht, n):
    from heat_tpu.core import fusion as JF
    from heat_tpu.parallel import transport as JT

    rng = np.random.default_rng(11)
    src = rng.standard_normal((13, 10)).astype(np.float32)
    jc, tc = _pair(ht, n)
    for name, (chain, fuses) in TAILS.items():
        with PF.fuse(False):
            ref = chain(htt.array(src, split=0, comm=tc, device="cpu"), htt).resplit(1)
        PT.reset_stats()
        JT.reset_stats()
        y = chain(htt.array(src, split=0, comm=tc, device="cpu"), htt)
        runs = []
        orig = PF._run_many
        PF._run_many = lambda exprs, _o=orig: runs.append(1) or _o(exprs)
        try:
            out = y.resplit(1)
        finally:
            PF._run_many = orig
        assert out.split == 1 == ref.split
        for got, want in zip(out.lshards(), ref.lshards()):
            _eq(got, want)
        j = chain(ht.array(src, split=0, comm=jc), ht).resplit(1)
        assert PT.stats()["fused_tails"] == JT.stats()["fused_tails"] == (1 if fuses and n > 1 else 0), name
        # no old-split materialization when the tail fuses
        assert (len(runs) == 0) == (fuses and n > 1), name
        np.testing.assert_allclose(out.numpy().astype(np.float32), np.asarray(j.larray).astype(np.float32),
                                   rtol=1e-6, atol=1e-6)
        # the chain stays pending for its other consumers, in its own split
        assert y.split == 0
        _eq(y.numpy(), chain(htt.array(src, split=0, comm=tc, device="cpu"), htt).numpy())


@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("band_cols", [1, 3, 7])
def test_split_tail_bands_across_destinations(n, band_cols):
    """Bands narrower than a destination, and bands that cross from one
    destination into the next: bitwise the materialize-then-resplit
    result."""
    rng = np.random.default_rng(12)
    src = rng.standard_normal((29, 23)).astype(np.float32)
    comm = htt.MeshComm(n)
    with PF.fuse(False):
        ref = (htt.exp(htt.array(src, split=0, comm=comm, device="cpu") * 0.1) - 1.0).resplit(1)
    y = htt.exp(htt.array(src, split=0, comm=comm, device="cpu") * 0.1) - 1.0
    rows = -(-29 // n)
    shards = PF.materialize_resplit(y, 1, tile_bytes=band_cols * rows * 4)
    assert shards is not None and len(shards) == n
    for got, want in zip(shards, ref.lshards()):
        _eq(got.numpy(), want)


@pytest.mark.parametrize("n", (4, 8))
def test_split_tail_in_place_and_reshape(n):
    src = np.arange(16 * 12, dtype=np.float32).reshape(16, 12)
    tc = htt.MeshComm(n)
    PT.reset_stats()
    y = htt.sqrt(htt.array(src, split=0, comm=tc, device="cpu") + 1.0)
    y.resplit_(1)
    assert y.split == 1 and PT.stats()["fused_tails"] == 1
    with PF.fuse(False):
        ref = htt.sqrt(htt.array(src, split=0, comm=tc, device="cpu") + 1.0).resplit(1)
    _eq(y.numpy(), ref.numpy())
    got = htt.reshape(htt.array(src, split=1, comm=tc, device="cpu") * 3.0, (12, 16), new_split=0)
    with PF.fuse(False):
        want = htt.reshape(htt.array(src, split=1, comm=tc, device="cpu") * 3.0, (12, 16), new_split=0)
    assert PT.stats()["fused_tails"] == 2
    _eq(got.numpy(), want.numpy())


@pytest.mark.parametrize("n", MESHES)
def test_fused_kmeans_step_one_k1_call_a_position(ht, n, monkeypatch):
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.standard_normal((40, 6)) + 4, rng.standard_normal((40, 6)) - 4]).astype(np.float32)
    C = X[[0, 50, 7]]
    jc, tc = _pair(ht, n)
    calls = []
    orig = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda *a, **k: calls.append(1) or orig(*a, **k))
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(C, device="cpu", comm=tc), max_iter=1)
    km._cluster_centers = htt.array(C, device="cpu", comm=tc)
    x = htt.array(X, split=0, comm=tc, device="cpu")
    PF.reset_cache()
    labels, inertia = km._assign_to_cluster(x, return_inertia=True)
    assert len(calls) == n  # one K1 call a position serves both roots
    assert PF.cache_stats()["roots_per_program"] == {2: 1}
    with PF.fuse(False):
        l2, i2 = km._assign_to_cluster(x, return_inertia=True)
    _eq(labels.numpy(), l2.numpy())
    assert inertia == i2
    jk = ht.cluster.KMeans(n_clusters=3, init=ht.array(C, comm=jc), max_iter=1)
    jk._cluster_centers = ht.array(C, comm=jc)
    jl, ji = jk._assign_to_cluster(ht.array(X, split=0, comm=jc), return_inertia=True)
    _eq(labels.numpy().astype(np.int64), np.asarray(jl.larray).astype(np.int64))
    np.testing.assert_allclose(inertia, ji, rtol=1e-5)
