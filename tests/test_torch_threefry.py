"""Random numbers on heat_tpu's Threefry streams: heat_tpu_torch against
heat_tpu (and jax.random) on the CPU, and T1 against its plain version on
the card.

The same seed, shape, dtype, split and mesh give the same numbers.  Bits,
uniforms, integers and permutations are compared bitwise.  Normal draws go
through ``log1p``, whose f32 and f64 results differ by an ulp or two between
XLA's CPU code and torch's, so they are held to a stated bound: within
``ULP_F32`` = 4 ulp in f32 (3 measured over 1.5e6 draws), ``ULP_F64`` = 64
ulp in f64 (30 measured), and 1 ulp in bf16 and f16 (their f32 draw rounded;
bf16 was bit-equal over the same draws).  The counter range across 2**32 is
checked through T1's start-counter argument against jax's Threefry
primitive, with no 2**32-element array.
"""


import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import random as htt_random
from heat_tpu_torch.ops import threefry as t1

MESHES = (1, 4, 8)
ULP_F32 = 4
ULP_F64 = 64
SEEDS = (0, 42, 2**31 - 1)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def jax_random(ht):
    import jax

    return jax.random


def _jcomm(ht, n):
    return ht.parallel.mesh.local_mesh(n)


def _key_data(jax_random, key):
    return tuple(int(v) for v in np.asarray(jax_random.key_data(key)))


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| in units of the spacing at the larger magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    big = np.maximum(np.abs(a), np.abs(b))
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(big.astype(a.dtype)).astype(np.float64)))


def _np(x):
    """A DNDarray's values as numpy, 16-bit floats as float32."""
    t = x.larray if hasattr(x, "larray") and isinstance(x.larray, torch.Tensor) else None
    if t is not None:
        return t.float().numpy() if t.dtype in (torch.bfloat16, torch.float16) else t.numpy()
    import jax.numpy as jnp

    v = x.larray
    return np.asarray(v.astype(jnp.float32)) if v.dtype in (jnp.bfloat16, jnp.float16) else np.asarray(v)


# ------------------------------------------------------------------ keys, bits
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_follow_prngkey_and_fold_in(jax_random, seed):
    import jax

    key = jax_random.PRNGKey(seed)
    assert htt_random._seed_key(seed) == _key_data(jax_random, key)
    for data in (0, 1, 7, 2**32 - 1):
        assert t1.fold_in(htt_random._seed_key(seed), data) == _key_data(jax_random, jax_random.fold_in(key, data))
    assert [t1.fold_in(htt_random._seed_key(seed), i) for i in range(3)] == [
        _key_data(jax_random, k) for k in jax_random.split(key, 3)
    ]
    # a seed outside int32 keeps its low 32 bits, as PRNGKey does outside x64
    with jax.enable_x64(False):
        for big in (2**32 + 5, -1, -(2**31), 2**63 - 1):
            assert htt_random._seed_key(big) == _key_data(jax_random, jax_random.PRNGKey(big))


def test_bits_and_uniforms_match_jax(jax_random):
    import jax.numpy as jnp

    key = jax_random.PRNGKey(42)
    kd, shape, n = _key_data(jax_random, key), (37, 41), 37 * 41
    np.testing.assert_array_equal(
        t1.reference_threefry(kd, n).numpy().view(np.uint32), np.asarray(jax_random.bits(key, shape, "uint32")).ravel()
    )
    np.testing.assert_array_equal(
        t1.reference_threefry(kd, n, kind="bits64").numpy().view(np.uint64),
        np.asarray(jax_random.bits(key, shape, "uint64")).ravel(),
    )
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64), (jnp.bfloat16, torch.bfloat16),
                   (jnp.float16, torch.float16)):
        want = np.asarray(jax_random.uniform(key, shape, jd).astype(jnp.float32)).ravel()
        got = t1.reference_threefry(kd, n, kind="uniform", dtype=td).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_counters_across_two_to_the_32(jax_random):
    import jax.numpy as jnp
    from jax._src.prng import threefry2x32_p

    kd = _key_data(jax_random, jax_random.PRNGKey(7))
    start = 2**32 - 1000
    c = np.arange(start, start + 2000, dtype=np.uint64)
    y0, y1 = threefry2x32_p.bind(jnp.uint32(kd[0]), jnp.uint32(kd[1]), jnp.asarray((c >> 32).astype(np.uint32)),
                                 jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32)))
    y0, y1 = np.asarray(y0), np.asarray(y1)
    assert (c >> 32).min() == 0 and (c >> 32).max() == 1
    np.testing.assert_array_equal(t1.threefry(kd, 2000, start=start).numpy().view(np.uint32), y0 ^ y1)
    np.testing.assert_array_equal(t1.threefry(kd, 2000, start=start, kind="bits64").numpy().view(np.uint64),
                                  (y0.astype(np.uint64) << 32) | y1)
    floats = (((y0 ^ y1) >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    np.testing.assert_array_equal(t1.threefry(kd, 2000, start=start, kind="uniform").numpy(), floats)
    # the draw's counters are its flat indices: the tail of a draw is its
    # window of the stream
    np.testing.assert_array_equal(t1.threefry(kd, 3000)[1000:].numpy(), t1.threefry(kd, 2000, start=1000).numpy())
    with pytest.raises(ValueError):
        t1.threefry(kd, 2, start=2**64 - 1)


def test_normals_within_the_stated_ulps(jax_random):
    import jax.numpy as jnp

    for seed in (0, 5):
        key = jax_random.PRNGKey(seed)
        kd, n = _key_data(jax_random, key), 1 << 14
        want = np.asarray(jax_random.normal(key, (n,), jnp.float32))
        got = t1.reference_threefry(kd, n, kind="normal").numpy()
        assert _ulps(got, want) <= ULP_F32 and np.mean(got == want) > 0.98
        want = np.asarray(jax_random.normal(key, (n,), jnp.float64))
        got = t1.reference_threefry(kd, n, kind="normal", dtype=torch.float64).numpy()
        assert _ulps(got, want) <= ULP_F64 and np.mean(got == want) > 0.8
        for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)):
            want = np.asarray(jax_random.normal(key, (n,), jnp.float32).astype(jd)).view(np.int16).astype(np.int64)
            got = t1.reference_threefry(kd, n, kind="normal", dtype=td).view(torch.int16).numpy().astype(np.int64)
            assert np.abs(got - want).max() <= 1


LIMIT_DRAWS = [
    (-(2**63), 2**63 - 1, "int64"),
    (2**62, 2**63 - 1, "int64"),
    (-5, 2**63 - 7, "int64"),
    (0, 1, "int64"),
    (7, 2**31 + 5, "int32"),
    (-3, 300, "uint8"),
    (-300, 20, "int8"),
]


@pytest.mark.parametrize("low, high, dtype", LIMIT_DRAWS)
def test_randint_at_the_dtype_limits(ht, low, high, dtype):
    # spans past 2**63 take the unsigned remainder's one-subtraction branch
    ht.random.seed(9)
    htt.random.seed(9)
    a = ht.random.randint(low, high, (5, 7), dtype=getattr(ht, dtype))
    b = htt.random.randint(low, high, (5, 7), dtype=getattr(htt, dtype), device="cpu")
    np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))


def test_unsigned_remainder_of_int64_words():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(0, 2**64, 500, dtype=np.uint64)] + [0, 1, 2**63 - 1, 2**63, 2**64 - 1]
    v = torch.tensor(vals, dtype=torch.uint64).view(torch.int64)
    for m in (0, 1, 3, 2**32, 2**62 + 3, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1, 12345678901234567890):
        got = [x % 2**64 for x in t1._umod64(v, m).tolist()]
        assert got == [x if m == 0 else x % m for x in vals], m


def test_randint_windows_are_the_streams_tail():
    kd = t1.fold_in((0, 5), 2)
    for dtype, bounds in ((torch.int32, (-7, 1000)), (torch.int64, (-(2**40), 2**50)), (torch.int16, (-9, 9))):
        whole = t1.threefry(kd, 3000, kind="randint", dtype=dtype, bounds=bounds)
        tail = t1.threefry(kd, 2000, start=1000, kind="randint", dtype=dtype, bounds=bounds)
        assert whole.dtype == dtype and torch.equal(whole[1000:], tail)
    with pytest.raises(TypeError):
        t1.threefry(kd, 3, kind="randint", dtype=torch.float32, bounds=(0, 3))


# ------------------------------------------------------------- the samplers
DRAWS = [
    ("rand", (13, 5), {}, "float32"),
    ("rand", (13, 5), {}, "float64"),
    ("rand", (7, 6), {}, "bfloat16"),
    ("rand", (7, 6), {}, "float16"),
    ("randn", (13, 5), {}, "float32"),
    ("randn", (11, 4), {}, "float64"),
    ("randn", (9, 6), {}, "bfloat16"),
    ("randn", (9, 6), {}, "float16"),
    ("randint", (-5, 17), {"size": (13, 3)}, "int32"),
    ("randint", (0, 256), {"size": (24, 2)}, "uint8"),
    ("randint", (-128, 128), {"size": (24, 2)}, "int8"),
    ("randint", (-(2**15), 2**15), {"size": (24, 2)}, "int16"),
    ("randint", (-(2**31), 2**31), {"size": (24, 2)}, "int32"),
    ("randint", (-100, 2**40), {"size": (12, 2)}, "int64"),
    ("randint", (3, 3), {"size": (12, 2)}, "int16"),
]


@pytest.mark.parametrize("mesh, split", [(1, None), (4, 0), (4, 1), (8, 0), (8, 1)])
def test_samplers_match_heat_tpu(ht, mesh, split):
    jc, tc = _jcomm(ht, mesh), htt.MeshComm(mesh)
    for seed in SEEDS if (mesh, split) == (4, 0) else SEEDS[1:2]:
        for name, args, kw, dtype in DRAWS:
            ht.random.seed(seed)
            htt.random.seed(seed)
            a = getattr(ht.random, name)(*args, **kw, dtype=getattr(ht, dtype), split=split, comm=jc)
            b = getattr(htt.random, name)(*args, **kw, dtype=getattr(htt, dtype), split=split, comm=tc, device="cpu")
            assert b.dtype.__name__ == dtype and b.shape == a.shape and b.split == a.split
            got, want = _np(b), _np(a)
            if name == "randn" and dtype in ("float32", "float64"):
                assert _ulps(got, want) <= (ULP_F32 if dtype == "float32" else ULP_F64), (name, dtype)
            elif name == "randn":
                assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max(), (name, dtype)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {dtype}")
            assert htt.random.get_state() == ht.random.get_state()
            if split is not None:
                assert [s.shape for s in b.lshards()] == [tuple(int(d) for d in m) for m in b.lshape_map]


def test_scalar_draws_and_dtype_errors(ht):
    ht.random.seed(3)
    htt.random.seed(3)
    assert float(htt.random.rand(device="cpu")) == float(ht.random.rand())
    np.testing.assert_array_equal(htt.random.rand(4, device="cpu").numpy(), np.asarray(ht.random.rand(4).numpy()))
    with pytest.raises(TypeError):
        htt.random.rand(3, dtype=htt.int32, device="cpu")
    with pytest.raises(TypeError):
        htt.random.randint(0, 3, (2,), dtype=htt.float32, device="cpu")


def test_chunked_sixteen_bit_draws(ht, monkeypatch):
    # the chunk limit shrunk in both packages; (203, 48) is a shape no other
    # test draws, so heat_tpu's compiled-sampler cache has not seen it
    monkeypatch.setattr(ht.random, "_CHUNK_F32_BYTES", 4 * 1500)
    monkeypatch.setattr(htt_random, "_CHUNK_F32_BYTES", 4 * 1500)
    for name, args, dtype in (("randn", (203, 48), "bfloat16"), ("rand", (203, 48), "float16"),
                              ("randint", (-9, 9), "int16")):
        kw = {"size": (203, 48)} if name == "randint" else {}
        for mesh in (1, 4):
            ht.random.seed(21)
            htt.random.seed(21)
            a = getattr(ht.random, name)(*args, **kw, dtype=getattr(ht, dtype), split=0, comm=_jcomm(ht, mesh))
            b = getattr(htt.random, name)(*args, **kw, dtype=getattr(htt, dtype), split=0, comm=htt.MeshComm(mesh),
                                          device="cpu")
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=f"{name} {dtype} mesh {mesh}")
    # the blocks are not the unchunked draw
    htt.random.seed(21)
    whole = htt.random.randn(203, 48, dtype=htt.float32, device="cpu").numpy()
    assert not np.array_equal(whole.astype(np.float32), _np(b).astype(np.float32))


# ------------------------------------------------------------- permutations
@pytest.mark.parametrize("mesh", MESHES)
def test_permutations_match_heat_tpu(ht, mesh):
    jc, tc = _jcomm(ht, mesh), htt.MeshComm(mesh)
    for n, split in ((1, None), (50, None), (1700, None), (3000, 0), (7, 0), (3, 0)):
        ht.random.seed(13)
        htt.random.seed(13)
        a = ht.random.randperm(n, dtype=ht.int64, split=split, comm=jc)
        b = htt.random.randperm(n, dtype=htt.int64, split=split, comm=tc, device="cpu")
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()), err_msg=f"randperm {n} {split}")
        assert htt.random.get_state() == ht.random.get_state()
    x = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
    labels = np.arange(37) % 5
    for split in (None, 0, 1):
        ht.random.seed(5)
        htt.random.seed(5)
        a = ht.random.permutation(ht.array(x, split=split, comm=jc))
        b = htt.random.permutation(htt.array(x, split=split, comm=tc, device="cpu"))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()), err_msg=f"permutation split {split}")
    ht.random.seed(6)
    htt.random.seed(6)
    a = ht.random.permutation(12, split=0, comm=jc)
    b = htt.random.permutation(12, split=0, comm=tc, device="cpu")
    np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))
    ht.random.seed(7)
    htt.random.seed(7)
    ja = ht.random.shuffle_rows([ht.array(x, split=0, comm=jc), ht.array(labels, split=0, comm=jc)])
    tb = htt.random.shuffle_rows([htt.array(x, split=0, comm=tc, device="cpu"),
                                  htt.array(labels, split=0, comm=tc, device="cpu")])
    for u, v in zip(tb, ja):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v.numpy()))
    assert htt.random.get_state() == ht.random.get_state()


def test_sort_rounds_keep_tied_keys_in_order(monkeypatch):
    # XLA's sort_key_val is stable; so is the port's: equal keys keep the
    # order of the previous round
    monkeypatch.setattr(htt_random.t1, "threefry", lambda key, n, **kw: torch.zeros(n, dtype=torch.int32))
    p = htt_random._sort_perm((0, 1), 3000, "cpu")
    np.testing.assert_array_equal(p.numpy(), np.arange(3000))


@pytest.mark.parametrize("seed", SEEDS)
def test_state_round_trip(ht, seed):
    ht.random.seed(seed)
    htt.random.seed(seed)
    ht.random.rand(3)
    htt.random.rand(3, device="cpu")
    assert htt.random.get_state() == ht.random.get_state() == ("Threefry", seed, 1, 0, 0.0)
    htt.random.rand(4, device="cpu")
    htt.random.set_state(("Threefry", seed, 1))
    np.testing.assert_array_equal(htt.random.rand(5, device="cpu").numpy(), np.asarray(ht.random.rand(5).numpy()))


# --------------------------------------------------- fits and data on the streams
@pytest.mark.parametrize("mesh", MESHES)
def test_randomly_seeded_kmeans_gives_heat_tpus_centres(ht, mesh):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c, 0.5, (40, 3)) for c in (0, 4, 8, -4)]).astype(np.float32)
    for init in ("random", "kmeans++"):
        a = ht.cluster.KMeans(n_clusters=4, init=init, random_state=7, max_iter=20).fit(
            ht.array(x, split=0, comm=_jcomm(ht, mesh)))
        b = htt.cluster.KMeans(n_clusters=4, init=init, random_state=7, max_iter=20).fit(
            htt.array(x, split=0, comm=htt.MeshComm(mesh), device="cpu"))
        np.testing.assert_allclose(b.cluster_centers_.numpy(), np.asarray(a.cluster_centers_.numpy()), rtol=1e-6, atol=1e-6)
        assert a.n_iter_ == b.n_iter_


def test_spherical_dataset_gives_heat_tpus_values(ht):
    from heat_tpu.utils.data import spherical as js
    from heat_tpu_torch.utils.data import spherical as ts

    a = js.create_spherical_dataset(100, random_state=3)
    htt.use_device("cpu")
    try:
        b = ts.create_spherical_dataset(100, random_state=3)
    finally:
        htt.use_device("gpu")
    assert b.shape == a.shape and b.split == a.split
    # the draws are bitwise; sin/cos round differently in the two libraries
    np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()), rtol=0, atol=4 * np.spacing(np.float32(12)))


def test_epoch_shuffles_give_heat_tpus_order(ht):
    from heat_tpu.utils.data import datatools as jd
    from heat_tpu_torch.utils.data import datatools as td

    x = np.arange(29 * 3, dtype=np.float32).reshape(29, 3)
    y = np.arange(29) % 4
    # heat_tpu draws the replicated case's randperm on its default mesh, the
    # conftest's 8 devices, so that case runs at mesh 8
    for mesh, split in ((4, 0), (8, None), (1, 0)):
        jc, tc = _jcomm(ht, mesh), htt.MeshComm(mesh)
        a = jd.Dataset(ht.array(x, split=split, comm=jc), ht.array(y, split=split, comm=jc))
        b = td.Dataset(htt.array(x, split=split, comm=tc, device="cpu"), htt.array(y, split=split, comm=tc, device="cpu"))
        ht.random.seed(17)
        htt.random.seed(17)
        for _ in range(2):
            a.shuffle()
            b.shuffle()
            for u, v in zip(b.arrays, a.arrays):
                np.testing.assert_array_equal(u.numpy(), np.asarray(v.numpy()))


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_bits_and_uniforms_on_card(cuda):
    kd = t1.fold_in((0, 42), 3)
    for start, n in ((0, 1), (0, 100_003), (2**32 - 5000, 10_000), (2**40 + 17, 4097)):
        before = t1.launches
        for kind, dtype in (("bits32", None), ("bits64", None), ("uniform", torch.float32),
                            ("uniform", torch.float64), ("uniform", torch.bfloat16), ("uniform", torch.float16)):
            got = t1.threefry(kd, n, start=start, kind=kind, dtype=dtype, device=cuda)
            want = t1.reference_threefry(kd, n, start=start, kind=kind, dtype=dtype, device=cuda)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (start, n, kind, dtype)
        assert t1.launches == before + 6


@pytest.mark.gpu
def test_kernel_normals_on_card(cuda):
    kd = t1.fold_in((0, 1), 0)
    n = 1 << 20
    for dtype, tol in ((torch.float32, 2), (torch.float64, 2), (torch.bfloat16, 1), (torch.float16, 1)):
        got = t1.threefry(kd, n, kind="normal", dtype=dtype, device=cuda).cpu()
        want = t1.reference_threefry(kd, n, kind="normal", dtype=dtype, device=cuda).cpu()
        if dtype in (torch.bfloat16, torch.float16):
            assert (got.view(torch.int16).long() - want.view(torch.int16).long()).abs().max() <= tol
        else:
            assert _ulps(got.numpy(), want.numpy()) <= tol
    out = torch.empty(10, device=cuda)
    assert t1.threefry(kd, 10, kind="uniform", device=cuda, out=out) is out
    with pytest.raises(TypeError):
        t1.threefry(kd, 10, kind="normal", dtype=torch.int32, device=cuda)


@pytest.mark.gpu
def test_kernel_randint_on_card(cuda):
    kd = t1.fold_in((0, 42), 4)
    bounds = [(torch.int32, (-5, 17)), (torch.int32, (-(2**31), 2**31)), (torch.int64, (-100, 2**40)),
              (torch.int64, (-(2**63), 2**63 - 1)), (torch.int64, (2**62, 2**63 - 1)), (torch.int16, (-(2**15), 2**15)),
              (torch.int8, (-128, 128)), (torch.uint8, (0, 256)), (torch.int32, (3, 3))]
    for start, n in ((0, 100_003), (2**32 - 5000, 10_000)):
        before = t1.launches
        for dtype, (low, high) in bounds:
            got = t1.threefry(kd, n, start=start, kind="randint", dtype=dtype, bounds=(low, high), device=cuda)
            want = t1.reference_threefry(kd, n, start=start, kind="randint", dtype=dtype, bounds=(low, high), device=cuda)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), (start, dtype, low, high)
        assert t1.launches == before + len(bounds)


@pytest.mark.gpu
def test_random_on_card_launches_the_kernel(cuda):
    htt.random.seed(4)
    before = t1.launches
    a = htt.random.randn(1000, 8, split=0, comm=htt.MeshComm(4), device="gpu")
    b = htt.random.randint(0, 10, (100,), device="gpu")
    assert t1.launches == before + 2  # one normal draw, one randint draw
    htt.random.seed(4)
    c = htt.random.randn(1000, 8, split=0, comm=htt.MeshComm(4), device="cpu")
    # the card's log1pf and the CPU's log1p differ by an ulp or two
    assert _ulps(a.larray.cpu().numpy(), c.numpy()) <= ULP_F32
    htt.random.seed(4)
    htt.random.rand(1, device="gpu")
    assert bool((b.larray >= 0).all()) and bool((b.larray < 10).all())
    # a 64-bit randint is drawn on the card, equal to the CPU's
    htt.random.seed(5)
    d = htt.random.randint(-(2**62), 2**62, (999,), dtype=htt.int64, device="gpu").larray
    htt.random.seed(5)
    assert torch.equal(d.cpu(), htt.random.randint(-(2**62), 2**62, (999,), dtype=htt.int64, device="cpu").larray)
