"""Statistics and relational operations: heat_tpu_torch against heat_tpu on
the CPU at meshes 1/4/8 and splits None/0 (and 1 for the reductions).

Exact agreement is required of shapes, dtypes, splits, shard layouts, and
of every value that is a selection or an index: ``max``/``min`` and their
arg forms, ``maximum``/``minimum``, ``median``/``percentile`` at lower/
higher/nearest/midpoint, ``bincount``, the histograms' counts,
``digitize``/``bucketize``, the comparisons and ``equal``.  Sums taken in
other orders (``var``/``std``, the moments, ``average``, ``cov``, linear
percentiles) agree to rtol 1e-5 in f32 and 1e-12 in f64; 16-bit results to
one ulp of their type (2^-7).
"""

import numpy as np
import pytest

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
RTOL = {"float32": 1e-5, "float64": 1e-12, "int32": 1e-5, "bfloat16": 2**-7, "float16": 2**-10}


def _np(data, dtype):
    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        return np.asarray(data, np.float32).astype(ml_dtypes.bfloat16)
    return np.asarray(data).astype(dtype)


def _both(ht, n, data, split=None):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    return ht.array(data, split=split, comm=jc), htt.array(data, split=split, comm=tc, device="cpu")


def _same(a, b, rtol=0.0, atol=0.0, split=True):
    """Shape, dtype, split, shard shapes and values of a heat_tpu array
    ``a`` and a heat_tpu_torch array ``b`` (values exact unless a tolerance
    is given; NaN equal to NaN)."""
    assert tuple(b.shape) == tuple(a.shape)
    assert b.dtype.__name__ == a.dtype.__name__, (b.dtype, a.dtype)
    if split:
        assert b.split == a.split
        assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]
    got, want = b.numpy(), a.numpy()
    if got.dtype.kind == "V" or "bfloat16" in str(got.dtype):
        got, want = got.astype(np.float32), want.astype(np.float32)
    if rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _grid(splits, dtypes, base="float32"):
    """(mesh, split, dtype) cases: ``base`` at every mesh and split, the
    other dtypes at mesh 4 along the split axis 0."""
    return [(n, split, base) for n in MESHES for split in splits] + [(4, 0, d) for d in dtypes]


def _data(dtype, shape=(13, 5), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith("int") or dtype.startswith("uint"):
        return _np(rng.integers(0 if dtype.startswith("u") else -20, 20, size=shape), dtype)
    return _np(rng.normal(size=shape) * 3, dtype)


# ---------------------------------------------------------------- max, argmax
@pytest.mark.parametrize("n,split,dtype", _grid([None, 0, 1], ["int32", "float16", "bool", "uint8"]))
def test_max_argmax_min_argmin(ht, n, split, dtype):
    a, b = _both(ht, n, _data(dtype), split)
    for axis, keepdims in ((None, False), (0, False), (1, False), (0, True)):
        _same(ht.max(a, axis=axis, keepdims=keepdims), htt.max(b, axis=axis, keepdims=keepdims))
        _same(ht.argmax(a, axis=axis, keepdims=keepdims), htt.argmax(b, axis=axis, keepdims=keepdims))
        _same(ht.min(a, axis=axis, keepdims=keepdims), htt.min(b, axis=axis, keepdims=keepdims))
    _same(a.max(axis=0), b.max(axis=0))
    _same(a.argmax(axis=1), b.argmax(axis=1))


@pytest.mark.parametrize("n", MESHES)
def test_argmax_first_maximum_across_positions(ht, n):
    x = np.array([3, 9, 2, 9, 0, 5, 9, 0, 9, 0, 7, 9, 4], dtype=np.float32)
    a, b = _both(ht, n, x, 0)
    _same(ht.argmax(a, axis=0), htt.argmax(b, axis=0))
    assert int(htt.argmax(b, axis=0).item()) == 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("at", [2, 6])
def test_max_with_nan_is_numpys(ht, n, at, fused):
    with htt.fusion.fuse(fused):
        # reference fault (d) holds for max as for min: heat_tpu's max along
        # the split drops NaN over several positions (6 or 5 here at meshes
        # 4/8), so the port is held to numpy's NaN, and to heat_tpu at mesh 1
        x = np.array([3, 1, 5, 2, 0.5, 4, 5, 6], dtype=np.float32)
        x[at] = np.nan
        a, b = _both(ht, n, x, 0)
        assert np.isnan(htt.max(b).item()) and np.isnan(np.max(x))
        assert int(htt.argmax(b).item()) == at == int(ht.argmax(a).item())
        if n == 1:
            _same(ht.max(a), htt.max(b))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_max_complex_lexicographic(ht, n, split):
    x = np.array([1 + 2j, 3 - 1j, 3 + 0j, -1 + 5j, 3 - 4j, 2 + 9j, 0j], np.complex64)
    a, b = _both(ht, n, x, split)
    _same(ht.max(a), htt.max(b))


@pytest.mark.parametrize(
    "n,splits,dtypes",
    [(n, splits, ("float32", "float32")) for n in MESHES for splits in [(None, None), (0, None), (None, 0), (0, 0)]]
    + [(4, (0, None), dtypes) for dtypes in [("int32", "float32"), ("int16", "int64"), ("float16", "float32")]],
)
def test_maximum_minimum(ht, n, splits, dtypes):
    x, y = _data(dtypes[0], seed=1), _data(dtypes[1], seed=2)
    if dtypes[0].startswith("float"):
        x[0, 0] = np.nan
    a1, b1 = _both(ht, n, x, splits[0])
    a2, b2 = _both(ht, n, y, splits[1])
    _same(ht.maximum(a1, a2), htt.maximum(b1, b2))
    _same(ht.minimum(a1, a2), htt.minimum(b1, b2))
    row = y[0]
    _same(ht.maximum(a1, ht.array(row, comm=a1.comm)), htt.maximum(b1, htt.array(row, comm=b1.comm, device="cpu")))


# ----------------------------------------------------------------- var, std
@pytest.mark.parametrize("n,split,dtype", _grid([None, 0, 1], ["float64", "int32", "bfloat16"]))
def test_var_std(ht, n, split, dtype):
    a, b = _both(ht, n, _data(dtype, seed=3) + _np(5, dtype), split)
    rtol = RTOL[dtype]
    for axis, ddof in ((None, 0), (0, 1), (1, 0)):
        _same(ht.var(a, axis=axis, ddof=ddof), htt.var(b, axis=axis, ddof=ddof), rtol=rtol)
        _same(ht.std(a, axis=axis, ddof=ddof), htt.std(b, axis=axis, ddof=ddof), rtol=rtol)
    _same(ht.var(a, axis=0, keepdims=True), htt.var(b, axis=0, keepdims=True), rtol=rtol)
    _same(a.std(0, 1), b.std(0, 1), rtol=rtol)
    _same(a.var(), b.var(), rtol=rtol)


@pytest.mark.parametrize("n", MESHES)
def test_var_complex_is_real(ht, n):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(13, 3)) + 1j * rng.normal(size=(13, 3))).astype(np.complex64)
    a, b = _both(ht, n, x, 0)
    _same(ht.var(a, axis=0), htt.var(b, axis=0), rtol=1e-5)


# ---------------------------------------------------------- skew, kurtosis
@pytest.mark.parametrize("n,split,dtype", _grid([None, 0, 1], ["float64", "int32"]))
def test_skew_kurtosis(ht, n, split, dtype):
    # the moments divide sums of 3rd/4th powers: rtol 1e-4 in f32
    rng = np.random.default_rng(5)
    a, b = _both(ht, n, _np(rng.gamma(2.0, 2.0, size=(13, 5)) * (10 if dtype == "int32" else 1), dtype), split)
    rtol = 1e-4 if dtype != "float64" else 1e-10
    for axis, unbiased, fischer in ((None, True, True), (0, False, True), (1, True, False), (0, True, False)):
        _same(ht.skew(a, axis=axis, unbiased=unbiased), htt.skew(b, axis=axis, unbiased=unbiased), rtol=rtol, atol=1e-6)
        _same(
            ht.kurtosis(a, axis=axis, unbiased=unbiased, Fischer=fischer),
            htt.kurtosis(b, axis=axis, unbiased=unbiased, Fischer=fischer),
            rtol=rtol, atol=1e-6,
        )


# ------------------------------------------------------- median, percentile
METHODS = ["linear", "lower", "higher", "midpoint", "nearest"]


@pytest.mark.parametrize("n,split,dtype", _grid([None, 0], ["int32", "float64"]))
def test_percentile_both_routes(ht, n, split, dtype):
    # along the split of a distributed array heat_tpu takes its sorted-
    # selection route, elsewhere jnp.percentile's; 30 and 12.5/87.5 fall
    # between two rows of 13
    x = _data(dtype, shape=(13, 4), seed=6)
    a, b = _both(ht, n, x, split)
    for method in METHODS:
        tol = {} if method != "linear" else {"rtol": RTOL[dtype], "atol": 1e-6}
        for axis, q, keepdims in ((0, 30, False), (0, [0, 12.5, 50, 87.5, 100], True), (None, 50.0, False)):
            _same(
                ht.percentile(a, q, axis=axis, interpolation=method, keepdims=keepdims),
                htt.percentile(b, q, axis=axis, interpolation=method, keepdims=keepdims),
                **tol,
            )


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_median_and_nan_lanes(ht, n, split):
    x = _data("float32", shape=(13, 4), seed=7)
    a, b = _both(ht, n, x, split)
    for axis, keepdims in ((None, False), (0, True), (1, False)):
        _same(ht.median(a, axis=axis, keepdims=keepdims), htt.median(b, axis=axis, keepdims=keepdims), rtol=1e-6)
    x[3, 1] = np.nan
    a, b = _both(ht, n, x, split)
    for method in METHODS:
        got = htt.percentile(b, [10, 50], axis=0, interpolation=method)
        _same(ht.percentile(a, [10, 50], axis=0, interpolation=method), got, rtol=1e-6)
        assert np.isnan(got.numpy()[:, 1]).all() and not np.isnan(np.delete(got.numpy(), 1, axis=1)).any()


@pytest.mark.parametrize("n", MESHES)
def test_percentile_one_dimensional_bf16(ht, n):
    x = _data("bfloat16", shape=(29,), seed=8)
    for split in (None, 0):
        a, b = _both(ht, n, x, split)
        for method in METHODS:
            _same(ht.percentile(a, 40, interpolation=method), htt.percentile(b, 40, interpolation=method), rtol=2**-7)


# ------------------------------------------------------------------ average
@pytest.mark.parametrize("n,split,dtype", _grid([None, 0, 1], ["int32"]))
def test_average(ht, n, split, dtype):
    x = _data(dtype, seed=9)
    a, b = _both(ht, n, x, split)
    w = np.random.default_rng(10).random((13, 5)).astype(np.float32)
    wa, wb = _both(ht, n, w, split)
    for axis in (None, 0, 1):
        _same(ht.average(a, axis=axis), htt.average(b, axis=axis), rtol=1e-5, atol=1e-6)
        ra, rb = ht.average(a, axis=axis, weights=wa, returned=True), htt.average(b, axis=axis, weights=wb, returned=True)
        _same(ra[0], rb[0], rtol=1e-5, atol=1e-6)
        _same(ra[1], rb[1], rtol=1e-5)
    w1 = np.arange(1, 14, dtype=np.float32)
    _same(ht.average(a, axis=0, weights=w1), htt.average(b, axis=0, weights=w1), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------- cov
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_cov(ht, n, split):
    x = _data("float32", shape=(4, 13), seed=11)
    y = _data("float32", shape=(2, 13), seed=12)
    a, b = _both(ht, n, x, split)
    ya, yb = _both(ht, n, y, split)
    for kw in ({}, {"bias": True}, {"ddof": 3}):
        _same(ht.cov(a, **kw), htt.cov(b, **kw), rtol=1e-5, atol=1e-6)
    _same(ht.cov(a, rowvar=False), htt.cov(b, rowvar=False), rtol=1e-5, atol=1e-5)
    _same(ht.cov(a, ya), htt.cov(b, yb), rtol=1e-5, atol=1e-6)
    one = _data("int32", shape=(13,), seed=13)
    oa, ob = _both(ht, n, one, split)
    _same(ht.cov(oa), htt.cov(ob), rtol=1e-5)


# -------------------------------------------------- bincount and histograms
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_bincount(ht, n, split):
    x = np.random.default_rng(14).integers(0, 7, size=23).astype(np.int64)
    w = np.random.default_rng(15).random(23).astype(np.float32)
    a, b = _both(ht, n, x, split)
    wa, wb = _both(ht, n, w, split)
    _same(ht.bincount(a), htt.bincount(b))
    _same(ht.bincount(a, minlength=12), htt.bincount(b, minlength=12))
    _same(ht.bincount(a, weights=wa), htt.bincount(b, weights=wb), rtol=1e-6)


@pytest.mark.parametrize("n,split,dtype", _grid([None, 0], ["int32"]))
def test_histc_histogram(ht, n, split, dtype):
    # values off the bin edges, and one on the last edge (a closed bin)
    x = _np(np.random.default_rng(16).integers(0, 400, size=(37,)) * 0.25 + 0.1, dtype)
    a, b = _both(ht, n, x, split)
    _same(ht.histc(a, bins=7), htt.histc(b, bins=7))
    _same(ht.histc(a, bins=5, min=10.0, max=60.0), htt.histc(b, bins=5, min=10.0, max=60.0))
    for kw in ({}, {"bins": 6, "range": (0.0, 120.0)}, {"bins": 4, "density": True}):
        ha, ea = ht.histogram(a, **kw)
        hb, eb = htt.histogram(b, **kw)
        _same(ha, hb, rtol=1e-6)
        _same(ea, eb, rtol=1e-6)
    w = np.random.default_rng(17).random(37).astype(np.float32)
    wa, wb = _both(ht, n, w, split)
    _same(ht.histogram(a, bins=3, weights=wa)[0], htt.histogram(b, bins=3, weights=wb)[0], rtol=1e-6)


# --------------------------------------------------- digitize and bucketize
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_digitize_bucketize(ht, n, split):
    x = np.round(_data("float32", shape=(13, 3), seed=18) * 2) / 2
    bins = np.array([-4.0, -1.5, 0.0, 0.5, 3.0], np.float32)
    a, b = _both(ht, n, x, split)
    for right in (False, True):
        _same(ht.digitize(a, bins, right=right), htt.digitize(b, bins, right=right))
        _same(ht.digitize(a, bins[::-1].copy(), right=right), htt.digitize(b, bins[::-1].copy(), right=right))
        _same(ht.bucketize(a, bins, right=right), htt.bucketize(b, bins, right=right))
        _same(ht.bucketize(a, bins, out_int32=True, right=right), htt.bucketize(b, bins, out_int32=True, right=right))
    ba, bb = _both(ht, n, bins)
    _same(ht.bucketize(a, ba), htt.bucketize(b, bb))


def test_mpi_argreduce_combiners(ht):
    lhs = np.array([3.0, 1.0, 5.0, 5.0, 0.0, 1.0, 2.0, 3.0], np.float32)
    rhs = np.array([3.0, 2.0, 4.0, 5.0, 7.0, 0.0, 9.0, 1.0], np.float32)
    for name in ("mpi_argmax", "mpi_argmin"):
        want = np.asarray(getattr(ht, name)(lhs, rhs))
        got = getattr(htt, name)(lhs, rhs).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- relational
@pytest.mark.parametrize("n,split,dtype", _grid([None, 0], ["int32", "bool", "complex64"]))
def test_comparison_aliases(ht, n, split, dtype):
    x, y = _data(dtype if dtype != "complex64" else "float32", seed=19), _data(dtype if dtype != "complex64" else "float32", seed=20)
    if dtype == "complex64":
        x, y = (x + 1j * np.round(y)).astype(np.complex64), (np.round(x) + 1j * y).astype(np.complex64)
    else:
        y[::2] = x[::2]
    a1, b1 = _both(ht, n, x, split)
    a2, b2 = _both(ht, n, y, split)
    for name in ("eq", "ne", "lt", "le", "gt", "ge"):
        _same(getattr(ht, name)(a1, a2), getattr(htt, name)(b1, b2))
    for alias, name in (("greater", "gt"), ("greater_equal", "ge"), ("less", "lt"), ("less_equal", "le"),
                        ("not_equal", "ne")):
        assert getattr(htt, alias) is getattr(htt, name) and getattr(ht, alias) is getattr(ht, name)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0])
def test_equal_returns_a_python_bool(ht, n, split):
    x = _data("float32", seed=21)
    a, b = _both(ht, n, x, split)
    a2, b2 = _both(ht, n, x.copy(), 0)
    y = x.copy()
    y[12, 4] += 1
    a3, b3 = _both(ht, n, y, split)
    cases = [(a, a2, b, b2), (a, a3, b, b3), (a, x, b, x), (a, x[0], b, x[0]), (a, 1.0, b, 1.0),
             (a, x[:3], b, x[:3]), (a, a[:3], b, b[:3])]
    for ja, jb, ta, tb in cases:
        got = htt.equal(ta, tb)
        assert type(got) is bool and got == ht.equal(ja, jb)
    ones_a, ones_b = _both(ht, n, np.ones((4, 3), np.int32), split)
    assert htt.equal(ones_b, 1) is True and ht.equal(ones_a, 1) is True
