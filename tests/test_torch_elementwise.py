"""The elementwise surface and its scans and reductions: trigonometric,
exponential, rounding, logical and complex functions and the rest of the
arithmetic, heat_tpu_torch against heat_tpu on the CPU: one base dtype
at meshes 1/4/8 and splits None/0, and at mesh 4 along split 0 every
other of float16/32/64, bfloat16, int8/16/32/64, uint8, bool and
complex64 that the function takes.  NumPy's other names are checked to be
the same functions in both packages.

Tolerances: transcendental functions (trigonometric, exponential,
logarithmic, ``cbrt``, ``hypot``, ``logaddexp``, ``sinc``, ``angle``, the
modulus, sign and square of a complex number) are rounded differently by the two
libraries' CPU kernels: 4 ulps of the result type, relative, and as much
absolute near 0; in float64, 32 ulps (XLA's float64 ``arctanh`` is 7 ulps
from torch's).  Everything else is exact:
rounding, comparisons, predicates, integer and bitwise arithmetic, shifts,
``copysign``, ``fmod``/``mod``/``floordiv``, ``abs``/``sign``/``clip`` and
the integer scans and products.  Float scans and products along the split
axis combine per-shard results in another order: 4 ulps of the result.
"""

import numpy as np
import pytest

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)
FLOATS = ["float16", "float32", "float64", "bfloat16"]
INTS = ["int8", "int16", "int32", "int64", "uint8"]
ALL = FLOATS + INTS + ["bool", "complex64"]
EPS = {"float16": 2.0**-10, "bfloat16": 2.0**-7, "float32": 2.0**-23, "float64": 2.0**-52,
       "complex64": 2.0**-23, "complex128": 2.0**-52}


def _np(data, dtype):
    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        return np.asarray(data, np.float32).astype(ml_dtypes.bfloat16)
    return np.asarray(data).astype(dtype)


def _host(a):
    v = a.numpy()
    return v.astype(np.float32) if "bfloat16" in str(v.dtype) else v


def _both(ht, n, data, split=None):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    return ht.array(data, split=split, comm=jc), htt.array(data, split=split, comm=tc, device="cpu")


def _same(a, b, ulps=0):
    """Shape, dtype, split, shard shapes and values (NaN equal to NaN);
    ``ulps`` > 0 allows that many ulps of the result type."""
    assert tuple(b.shape) == tuple(a.shape)
    assert b.dtype.__name__ == a.dtype.__name__, (b.dtype, a.dtype)
    assert b.split == a.split
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]
    got, want = _host(b), _host(a)
    if ulps:
        name = b.dtype.__name__
        tol = ulps * EPS[name] * (8 if name in ("float64", "complex128") else 1)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _at(n, dtypes, split=None):
    """The base dtype (the first of float32, int32 and bool that the
    function takes, or its first dtype) at every mesh and split; at mesh 4
    along split 0 also every other dtype."""
    base = ([d for d in ("float32", "int32", "bool") if d in dtypes] or list(dtypes))[0]
    if n == 4 and split == 0:
        return [base] + [d for d in dtypes if d != base]
    return [base]


def _splits_of(n, dtypes):
    """(dtype, split) cases: the base dtype at splits None and 0, the
    others of :func:`_at` at split 0."""
    return [(_at(n, dtypes)[0], None)] + [(d, 0) for d in _at(n, dtypes, 0)]


def _values(dtype, shape=(13, 3), lo=-3.0, hi=3.0, seed=0):
    """Values in [lo, hi] of ``dtype`` (integers rounded; bool half True;
    complex with an imaginary part in the same range)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(lo, hi, size=shape)
    if dtype == "bool":
        return v > (lo + hi) / 2
    if dtype in INTS:
        if dtype == "uint8":
            v = np.abs(v)
        return np.round(v).astype(dtype)
    if dtype == "complex64":
        return (v + 1j * rng.uniform(lo, hi, size=shape)).astype(np.complex64)
    return _np(v, dtype)


# ------------------------------------------------------------ unary, cast
# name: (domain, dtypes); integer and bool input is cast to float32 first,
# so two integer types stand for all of them
CAST_INTS = ["int16", "uint8"]
TRANSCENDENTAL = {
    "sin": ((-4, 4), FLOATS + ["int32", "bool", "complex64"]), "cos": ((-4, 4), FLOATS + ["int32", "bool", "complex64"]), "tan": ((-1.2, 1.2), FLOATS + CAST_INTS),
    "arcsin": ((-1, 1), FLOATS + ["int8", "bool"]),
    "arccos": ((-1, 1), FLOATS + ["int32"]),
    "arctan": ((-9, 9), FLOATS + CAST_INTS),
    "sinh": ((-4, 4), FLOATS + CAST_INTS), "cosh": ((-4, 4), FLOATS + ["int16"]), "tanh": ((-4, 4), FLOATS + ["int32", "bool", "complex64"]),
    "arcsinh": ((-9, 9), FLOATS + CAST_INTS),
    "arccosh": ((1, 9), FLOATS + ["uint8"]),
    "arctanh": ((-0.9, 0.9), FLOATS),
    "deg2rad": ((-360, 360), FLOATS + CAST_INTS),
    "rad2deg": ((-7, 7), FLOATS + CAST_INTS),
    "sinc": ((-3, 3), FLOATS + ["int32"]),
    "exp": ((-5, 5), FLOATS + ["int32", "bool", "complex64"]), "expm1": ((-2, 2), FLOATS + CAST_INTS), "exp2": ((-8, 8), FLOATS + CAST_INTS),
    "log": ((0.1, 50), FLOATS + ["int32", "bool", "complex64"]), "log2": ((0.1, 50), FLOATS + CAST_INTS), "log10": ((0.1, 50), FLOATS + CAST_INTS),
    "log1p": ((-0.5, 9), FLOATS + CAST_INTS), "sqrt": ((0, 50), FLOATS + ["int32", "bool", "complex64"]), "cbrt": ((-30, 30), FLOATS + CAST_INTS),
}
EXACT_CAST = {
    "ceil": ((-5, 5), FLOATS + INTS + ["bool"]), "floor": ((-5, 5), FLOATS + INTS + ["bool"]),
    "trunc": ((-5, 5), FLOATS + INTS), "fabs": ((-5, 5), FLOATS + INTS),
}


def _unary_cases(table):
    return [(name, n) for name in sorted(table) for n in MESHES]


def _check_unary(ht, name, n, domain, dtypes, ulps, **kw):
    for dtype, split in _splits_of(n, dtypes):
        x = _values(dtype, lo=domain[0], hi=domain[1], seed=len(name))
        a, b = _both(ht, n, x, split)
        _same(getattr(ht, name)(a, **kw), getattr(htt, name)(b, **kw), ulps=ulps)


@pytest.mark.parametrize("name,n", _unary_cases(TRANSCENDENTAL))
def test_transcendental(ht, name, n):
    domain, dtypes = TRANSCENDENTAL[name]
    _check_unary(ht, name, n, domain, dtypes, ulps=4)


@pytest.mark.parametrize("name,n", _unary_cases(EXACT_CAST))
def test_rounding_cast(ht, name, n):
    domain, dtypes = EXACT_CAST[name]
    _check_unary(ht, name, n, domain, dtypes, ulps=0)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("decimals", [0, 1, 2])
def test_round(ht, n, decimals):
    # halves land on ties, which both round to even
    x = np.concatenate([np.arange(-10, 11) * 0.5, np.arange(-10, 11) * 0.25]).astype(np.float32)
    for dtype in ("float32", "float64", "float16", "int32"):
        a, b = _both(ht, n, x.astype(dtype) if dtype != "int32" else np.round(x).astype(np.int32), 0)
        _same(ht.round(a, decimals), htt.round(b, decimals), ulps=0 if decimals == 0 else 1)
    a, b = _both(ht, n, x, None)
    _same(ht.round(a, dtype=ht.int32), htt.round(b, dtype=htt.int32))
    _same(a.round(1), b.round(1), ulps=1)


# ---------------------------------------------------------- unary, no cast
NO_CAST = {
    "abs": ALL, "sign": FLOATS + INTS + ["complex64"],
    "square": ALL, "neg": FLOATS + INTS + ["complex64"],
    "pos": ALL, "bitwise_not": INTS + ["bool"],
    "logical_not": ALL, "isfinite": ALL, "isinf": ALL, "isnan": ALL, "isneginf": FLOATS + INTS,
    "isposinf": FLOATS + INTS, "signbit": FLOATS + INTS, "conj": ALL,
    "real": ALL, "imag": ALL,
}


@pytest.mark.parametrize("name,n", _unary_cases(NO_CAST))
def test_no_cast(ht, name, n):
    for dtype, split in _splits_of(n, NO_CAST[name]):
        x = _values(dtype, seed=len(name))
        if dtype in FLOATS:
            x[0, 0], x[1, 1], x[2, 2], x[3, 0] = np.nan, np.inf, -np.inf, -0.0
        ulps = 4 if dtype == "complex64" and name in ("abs", "sign", "square") else 0
        a, b = _both(ht, n, x, split)
        _same(getattr(ht, name)(a), getattr(htt, name)(b), ulps=ulps)


@pytest.mark.parametrize("n", MESHES)
def test_angle(ht, n):
    for dtype in ("complex64", "float32", "int32"):
        x = _values(dtype, seed=5)
        for split in (None, 0):
            a, b = _both(ht, n, x, split)
            for deg in (False, True):
                _same(ht.angle(a, deg=deg), htt.angle(b, deg=deg), ulps=4)


@pytest.mark.parametrize("n", MESHES)
def test_clip_and_modf(ht, n):
    for dtype in ("float32", "int32", "float16", "uint8"):
        x = _values(dtype, lo=-6, hi=6, seed=6)
        for split in (None, 0):
            a, b = _both(ht, n, x, split)
            for lo, hi in ((-1, 2), (None, 3), (-2, None)) if dtype != "uint8" else ((1, 4), (None, 3)):
                _same(ht.clip(a, lo, hi), htt.clip(b, lo, hi))
            _same(a.clip(-1.5, 2.5), b.clip(-1.5, 2.5))
            if dtype != "uint8":
                for pa, pb in zip(ht.modf(a), htt.modf(b)):
                    _same(pa, pb)
    with pytest.raises(ValueError):
        htt.clip(htt.array([1.0], device="cpu"))


@pytest.mark.parametrize("n", MESHES)
def test_abs_dtype_and_operator(ht, n):
    a, b = _both(ht, n, _values("int32", seed=7), 0)
    _same(ht.abs(a, dtype=ht.float32), htt.abs(b, dtype=htt.float32))
    _same(abs(a), abs(b))


# ------------------------------------------------------------------ binary
# name: (left dtypes, right dtype, domain); each left dtype meets the right
BINARY = {
    "arctan2": (FLOATS + ["int32"], "float32", (-5, 5), 4),
    "logaddexp": (FLOATS + ["int32"], "float32", (-5, 5), 4),
    "logaddexp2": (["float32", "float64"], "float32", (-5, 5), 4),
    "hypot": (["float16", "float32", "float64", "int32"], "float32", (-5, 5), 4),
    "copysign": (FLOATS + ["int16"], "float32", (-5, 5), 0),
    "floordiv": (["float32", "float64", "int8", "int32", "int64"], "int32", (1, 7), 0),
    "mod": (["float32", "float64", "int16", "int32", "int64"], "int32", (1, 7), 0),
    "fmod": (["float32", "float64", "int16", "int32"], "int32", (1, 7), 0),
    "bitwise_and": (INTS + ["bool"], "int32", (0, 9), 0),
    "bitwise_or": (INTS + ["bool"], "int32", (0, 9), 0),
    "bitwise_xor": (INTS + ["bool"], "int32", (0, 9), 0),
    "left_shift": (["int8", "int16", "int32", "int64", "uint8"], "int32", (0, 4), 0),
    "right_shift": (["int8", "int16", "int32", "int64", "uint8"], "int32", (0, 4), 0),
    "logical_and": (ALL, "bool", (-2, 2), 0),
    "logical_or": (ALL, "bool", (-2, 2), 0),
    "logical_xor": (ALL, "bool", (-2, 2), 0),
    "isclose": (["float32", "float64", "int32"], "float32", (-2, 2), 0),
}
# NumPy's other names for the same functions, in both packages
ALIASES = {
    "asin": "arcsin", "acos": "arccos", "atan": "arctan", "asinh": "arcsinh", "acosh": "arccosh",
    "atanh": "arctanh", "atan2": "arctan2", "radians": "deg2rad", "degrees": "rad2deg",
    "absolute": "abs", "sgn": "sign", "negative": "neg", "positive": "pos", "invert": "bitwise_not",
    "conjugate": "conj", "floor_divide": "floordiv", "remainder": "mod", "multiply": "mul",
    "subtract": "sub", "cumproduct": "cumprod", "divide": "div", "power": "pow",
}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases(ht, alias):
    assert getattr(ht, alias) is getattr(ht, ALIASES[alias])
    assert getattr(htt, alias) is getattr(htt, ALIASES[alias])


@pytest.mark.parametrize("name,n", _unary_cases(BINARY))
def test_binary(ht, name, n):
    lefts, right, domain, ulps = BINARY[name]
    y = _values(right, lo=domain[0], hi=domain[1], seed=3)
    if name in ("floordiv", "floor_divide", "mod", "remainder", "fmod"):
        y = np.where(y == 0, 3, y).astype(right) * np.where(np.arange(3) == 1, -1, 1).astype(right)
    for dtype, split in _splits_of(n, lefts):
        lo = -9 if name in ("floordiv", "mod", "fmod", "floor_divide", "remainder") else domain[0]
        x = _values(dtype, lo=lo if dtype != "uint8" else 0, hi=max(domain[1], 9), seed=len(name))
        if name == "isclose":
            x = (y + np.where(np.arange(3) == 0, 0, 1e-6 * np.arange(13)[:, None])).astype(dtype)
        pairs = ((None, None), (0, None), (None, 0), (0, 0)) if split is None else ((0, None),)
        for split_x, split_y in pairs:
            a1, b1 = _both(ht, n, x, split_x)
            a2, b2 = _both(ht, n, y, split_y)
            _same(getattr(ht, name)(a1, a2), getattr(htt, name)(b1, b2), ulps=ulps)
        # a scalar on the right, and a broadcast row
        if split is None and name not in ("isclose", "logical_and", "logical_or", "logical_xor"):
            a1, b1 = _both(ht, n, x, 0)
            scalar = 2 if dtype in INTS + ["bool"] or name.endswith("shift") or name.startswith("bitwise") else 1.5
            _same(getattr(ht, name)(a1, scalar), getattr(htt, name)(b1, scalar), ulps=ulps)
            ar, br = _both(ht, n, y[0])
            _same(getattr(ht, name)(a1, ar), getattr(htt, name)(b1, br), ulps=ulps)


@pytest.mark.parametrize("n", MESHES)
def test_operators(ht, n):
    x, y = _values("int32", lo=1, hi=9, seed=8), _values("int32", lo=1, hi=5, seed=9)
    a1, b1 = _both(ht, n, x, 0)
    a2, b2 = _both(ht, n, y, None)
    for op in (lambda p, q: p // q, lambda p, q: p % q, lambda p, q: p << q, lambda p, q: p >> q,
               lambda p, q: p & q, lambda p, q: p | q, lambda p, q: p ^ q, lambda p, q: 7 // p,
               lambda p, q: 7 % p, lambda p, q: 6 & p, lambda p, q: 6 | p, lambda p, q: 6 ^ p):
        _same(op(a1, a2), op(b1, b2))
    _same(~a1, ~b1)
    _same(+a1, +b1)


@pytest.mark.parametrize("n", MESHES)
def test_allclose(ht, n):
    x = _values("float32", seed=10)
    for split in (None, 0):
        a, b = _both(ht, n, x, split)
        for y, kw in ((x, {}), (x + 1e-6, {}), (x + 1e-3, {}), (x + 1e-3, {"atol": 1e-2}), (x * (1 + 3e-5), {"rtol": 1e-4})):
            ay, by = _both(ht, n, y.astype(np.float32), split)
            got = htt.allclose(b, by, **kw)
            assert type(got) is bool and got == ht.allclose(a, ay, **kw)
        nan = x.copy()
        nan[0, 0] = np.nan
        an, bn = _both(ht, n, nan, split)
        for equal_nan in (False, True):
            assert htt.allclose(bn, bn, equal_nan=equal_nan) == ht.allclose(an, an, equal_nan=equal_nan)
            _same(ht.isclose(an, an, equal_nan=equal_nan), htt.isclose(bn, bn, equal_nan=equal_nan))


@pytest.mark.parametrize("n", MESHES)
def test_out_and_where(ht, n):
    x, y = _values("float32", seed=11), _values("float32", seed=12)
    mask = _values("bool", seed=13)
    for split in (None, 0):
        a1, b1 = _both(ht, n, x, split)
        a2, b2 = _both(ht, n, y, split)
        am, bm = _both(ht, n, mask, split)
        for name in ("add", "sub", "mul", "div", "hypot", "copysign", "maximum", "minimum"):
            _same(getattr(ht, name)(a1, a2, where=am), getattr(htt, name)(b1, b2, where=bm), ulps=4)
            oa, ob = _both(ht, n, np.full((13, 3), 7.0, np.float32), split)
            getattr(ht, name)(a1, a2, out=oa, where=am)
            got = getattr(htt, name)(b1, b2, out=ob, where=bm)
            assert got is ob
            np.testing.assert_allclose(ob.numpy(), oa.numpy(), rtol=4 * EPS["float32"])
        ob = htt.zeros((13, 3), dtype=htt.float64, split=split, comm=b1.comm, device="cpu")
        assert htt.sin(b1, out=ob) is ob and ob.dtype is htt.float64
        np.testing.assert_allclose(ob.numpy(), np.sin(x.astype(np.float64)), rtol=1e-6)


# ------------------------------------------------------ scans, reductions
SCAN_DTYPES = ["float32", "float64", "int8", "int32", "int64", "uint8", "bool", "float16"]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_cumsum_cumprod(ht, n, split, name):
    for dtype in _at(n, SCAN_DTYPES, split):
        lo, hi = (0.5, 1.5) if name == "cumprod" else (-3, 3)
        x = _values(dtype, lo=lo if dtype in FLOATS else -2, hi=hi if dtype in FLOATS else 2, seed=14)
        a, b = _both(ht, n, x, split)
        ulps = 4 if dtype in FLOATS else 0
        for axis in (0, 1):
            _same(getattr(ht, name)(a, axis), getattr(htt, name)(b, axis), ulps=ulps)
        _same(getattr(a, name)(0), getattr(b, name)(0), ulps=ulps)
    a, b = _both(ht, n, _values("int32", seed=15), split)
    _same(getattr(ht, name)(a, 0, dtype=ht.float64), getattr(htt, name)(b, 0, dtype=htt.float64))
    assert htt.cumproduct is htt.cumprod


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["prod", "nansum", "nanprod", "all", "any"])
def test_reductions(ht, n, split, name):
    for dtype in _at(n, ("float32", "float64", "int32", "uint8", "bool", "float16", "bfloat16"), split):
        lo, hi = (0.6, 1.4) if name.endswith("prod") else (-3, 3)
        x = _values(dtype, lo=lo if dtype in FLOATS else -1, hi=hi if dtype in FLOATS else 2, seed=16)
        if dtype in FLOATS and name.startswith("nan"):
            x[1, 1] = x[7, 0] = np.nan
        if name in ("all", "any"):
            x[:, 1] = 0 if name == "any" else x[:, 1]
            x[:, 2] = 1 if dtype != "bool" else True
        a, b = _both(ht, n, x, split)
        ulps = 4 if dtype in FLOATS and name not in ("all", "any") else 0
        for axis, keepdims in ((None, False), (0, False), (1, True), ((0, 1), False)):
            _same(getattr(ht, name)(a, axis=axis, keepdims=keepdims), getattr(htt, name)(b, axis=axis, keepdims=keepdims), ulps=ulps)
    _same(getattr(a, name)(axis=0) if hasattr(a, name) else getattr(ht, name)(a, axis=0),
          getattr(b, name)(axis=0) if hasattr(b, name) else getattr(htt, name)(b, axis=0), ulps=ulps)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_diff(ht, n, split):
    for dtype in _at(n, ("float32", "int32", "bool", "int8"), split):
        x = _values(dtype, shape=(13, 5), seed=17)
        a, b = _both(ht, n, x, split)
        for kw in ({}, {"axis": 0}, {"n": 2, "axis": 0}, {"n": 3}):
            _same(ht.diff(a, **kw), htt.diff(b, **kw))
    x = _values("float32", shape=(13, 5), seed=18)
    a, b = _both(ht, n, x, split)
    _same(ht.diff(a, axis=0, prepend=0.0, append=x[:2]), htt.diff(b, axis=0, prepend=0.0, append=x[:2]))
    pa, pb = _both(ht, n, x[:1], None)
    _same(ht.diff(a, axis=0, prepend=pa), htt.diff(b, axis=0, prepend=pb))


def test_bitwise_rejects_floats():
    b = htt.array(np.ones(3, np.float32), device="cpu")
    for fn in (htt.bitwise_and, htt.bitwise_or, htt.bitwise_xor, htt.left_shift):
        with pytest.raises(TypeError):
            fn(b, b) if fn is not htt.left_shift else fn(b, 1)
    with pytest.raises(TypeError):
        htt.bitwise_not(b)
