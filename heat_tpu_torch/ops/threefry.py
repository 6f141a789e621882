"""Threefry-2x32 counter streams, T1 of the port.

T1 has no Pallas counterpart: the JAX package draws through
``jax.random``, whose partitionable Threefry-2x32 XLA lowers to element-wise
integer code (jax/_src/prng.py ``_threefry_random_bits_partitionable``).
The port reproduces those streams bit for bit, so that one seed gives
``heat_tpu.random``'s numbers; on the card a chain of int64 torch ops would
run some twenty passes over 8-byte temporaries per draw, so the bits and
their uniform and normal transforms are one hand-written CUDA kernel
(``csrc/threefry.cu``) that writes each output once.

Element i of a draw of key (k0, k1) takes the 64-bit counter ``start + i``,
split into its high and low words (x0, x1); Threefry-2x32 maps them to
(y0, y1).  What is written:

* ``"bits32"``: ``y0 ^ y1`` (int32 holding the uint32 pattern);
* ``"bits64"``: ``y0 << 32 | y1`` (int64 holding the uint64 pattern);
* ``"uniform"``: ``jax.random.uniform``'s mantissa construction on
  [0, 1) in the output type (f32 and f16 from the 32-bit word, bf16 from
  its low 8 bits, f64 from the 64-bit word);
* ``"normal"``: ``sqrt(2) * erf_inv(u)`` of an f32 (or f64) uniform u on
  (nextafter(-1, 0), 1), f32 rounded to the output type.  ``erf_inv`` is
  XLA's polynomial of ``log1p`` (:func:`erfinv_f32`, :func:`erfinv_f64`);
  ``log1p`` itself is the platform's, so normals agree with XLA's CPU
  results within a few ulp, not bit for bit;
* ``"randint"``: ``jax.random.randint``'s integers in [low, high): the
  32-bit (64-bit for int64) words h of key ``fold_in(key, 0)`` and l of
  ``fold_in(key, 1)`` at the same counter, ``low + ((h % span) * mult +
  l % span) % span`` in unsigned arithmetic of that width
  (:func:`randint_params`); 8- and 16-bit types are drawn as int32 with
  their bounds clipped to the type, as jax draws them.

:func:`threefry` launches the kernel for a CUDA device and computes
:func:`reference_threefry` (int64 torch ops under a 32-bit mask) for the
CPU; there is no fallback between the two.  The kernel is bound by the
integer rounds (some 80 32-bit operations an element) more than by the
bytes it writes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["erfinv_f32", "erfinv_f64", "fold_in", "randint_params", "reference_threefry", "threefry", "threefry2x32"]

#: kernel launches so far; :func:`threefry` adds one per launch and nowhere else
launches = 0

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SOURCES = ("threefry.cu",)
_KINDS = {"bits32": 0, "bits64": 1, "uniform": 2, "normal": 3, "randint": 4}
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3, torch.int32: 4, torch.int64: 5,
          torch.int8: 6, torch.uint8: 7, torch.int16: 8}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)
_fn = None

# XLA's f32 erf_inv (Giles' single-precision approximation): one polynomial
# in w - 2.5 for w = -log1p(-x^2) < 5, another in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

# XLA's f64 erf_inv (Giles' double-precision approximation)
_ERFINV64_LT625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18, 1.1157877678025181e-17,
    -1.333171662854621e-16, 2.0972767875968562e-17, 6.637638134358324e-15, -4.054566272975207e-14,
    -8.151934197605472e-14, 2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08, 4.2347877827932404e-07,
    -1.3654692000834679e-06, -1.3882523362786469e-05, 0.00018673420803405714, -0.000740702534166267,
    -0.006033670871430149, 0.24015818242558962, 1.6536545626831027)
_ERFINV64_LT16 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07, 1.8239629214389228e-08,
    1.5027403968909828e-06, -4.013867526981546e-06, 2.9234449089955446e-06, 1.2475304481671779e-05,
    -4.7318229009055734e-05, 6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851, -0.003751208507569241,
    0.005370914553590064, 1.0052589676941592, 3.0838856104922208)
_ERFINV64_GE16 = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09, -3.789465440126737e-09,
    7.61570120807834e-09, -1.496002662714924e-08, 2.914795345090108e-08, -6.771199775845234e-08,
    2.2900482228026655e-07, -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122, 1.0103004648645344,
    4.849906401408584)

Key = Tuple[int, int]


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``: python ints below 2**32, or int64 tensors holding them.
    Returns the pair of output words in the same form."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the words of counter (0, data).
    Under the partitionable Threefry, ``jax.random.split(key, n)[i]`` is the
    same key as ``fold_in(key, i)``."""
    return threefry2x32(key, 0, int(data) & MASK)


def _signed32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 of the same bits."""
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once, as XLA's CPU code and the
    kernel's ``fmaf`` compute it (the f32 product is exact in f64)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c).to(torch.float32)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` in torch ops, each Horner step one fused
    multiply-add as XLA's CPU code contracts it; ±1 map to ±FLT_MAX·x."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt, a, b).to(torch.float32).to(torch.float64))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's f64 ``erf_inv`` (Giles' double-precision approximation: 23, 19
    and 17 coefficients for w = -log1p(-x^2) below 6.25, below 16, and
    above) in torch ops, without fused multiply-adds."""
    w = -torch.log1p(-x * x)
    lt625, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coefficient(i):
        c = torch.full_like(x, _ERFINV64_LT625[i])
        if i < 19:
            c = torch.where(lt625, c, _ERFINV64_LT16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV64_GE16[i])
        return c

    p = coefficient(0)
    for i in range(1, 23):
        step = coefficient(i) + p * w
        p = step if i < 17 else torch.where(lt16 if i < 19 else lt625, step, p)
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float64).max, p * x)


def _uniform(y0: torch.Tensor, y1: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform``'s construction on [0, 1) from the words of
    each element (its scale to [0, 1) changes no value)."""
    if dtype == torch.float64:
        bits = ((_signed32(y0).to(torch.int64) << 32) | y1) >> 12
        one = (bits & ((1 << 52) - 1)) | 0x3FF0000000000000
    elif dtype == torch.float32:
        one = _signed32(((y0 ^ y1) >> 9) | 0x3F800000)
    elif dtype == torch.float16:
        one = (((y0 ^ y1) & 0xFFFF) >> 6 | 0x3C00).to(torch.int16)
    elif dtype == torch.bfloat16:
        one = (((y0 ^ y1) & 0xFF) >> 1 | 0x3F80).to(torch.int16)
    else:
        raise TypeError(f"uniform only accepts floating point dtypes, got {dtype}")
    return one.view(dtype) - torch.ones((), dtype=dtype, device=one.device)


def _normal(y0: torch.Tensor, y1: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.normal``: u uniform on (nextafter(-1, 0), 1) in f32 (f64
    for f64), ``sqrt(2) * erf_inv(u)`` rounded to ``dtype``.  The f32 scale
    is one fused multiply-add, as XLA's CPU code computes it."""
    base = torch.float64 if dtype == torch.float64 else torch.float32
    floats = _uniform(y0, y1, base)
    lo = torch.nextafter(torch.tensor(-1.0, dtype=base), torch.tensor(0.0, dtype=base)).to(floats.device)
    span = 1.0 - lo
    scaled = _fma32(floats, span, float(lo)) if base == torch.float32 else floats * span + lo
    u = torch.maximum(lo, scaled)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=base, device=u.device)
    return (sqrt2 * (erfinv_f32(u) if base == torch.float32 else erfinv_f64(u))).to(dtype)


def randint_params(dtype: torch.dtype, low: int, high: int) -> Tuple[int, int, int, int]:
    """``jax.random.randint``'s scalars for integers of ``dtype`` in [low,
    high): ``(nbits, lo, span, mult)``, the width of the arithmetic, the
    lower bound clipped to the type, and the span and multiplier as
    unsigned ``nbits``-bit numbers (span 0 is the whole range: a remainder
    by 0 leaves its operand, as XLA's).  The bounds are clipped to the
    type; ``high`` above its maximum widens the span by one.  8- and 16-bit
    types take int32's arithmetic with bounds wrapped to 32 bits and
    clipped to the type (``high`` to its maximum + 1)."""
    if dtype not in _INTS:
        raise TypeError(f"randint only accepts integer dtypes, got {dtype}")
    if torch.iinfo(dtype).bits < 32:
        small = torch.iinfo(dtype)

        def wrap32(v):
            return ((int(v) + 2**31) % 2**32) - 2**31

        low = min(max(wrap32(low), small.min), small.max)
        high = min(max(wrap32(high), small.min), small.max + 1)
        dtype = torch.int32
    info = torch.iinfo(dtype)
    nbits = info.bits
    umask = (1 << nbits) - 1
    lo_c, hi_c = min(max(low, info.min), info.max), min(max(high, info.min), info.max)
    span = (hi_c - lo_c) & umask
    if hi_c <= lo_c:
        span = 1
    elif high > info.max:
        span = (span + 1) & umask

    def rem(v, m):
        return v if m == 0 else v % m

    mult = rem(1 << (nbits // 2), span)
    mult = rem((mult * mult) & umask, span)
    return nbits, lo_c, span, mult


def _signed64(v: int) -> int:
    """A 64-bit unsigned number as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _umod64(v: torch.Tensor, m: int) -> torch.Tensor:
    """``v % m`` for int64 ``v`` holding unsigned 64-bit numbers and a
    python int ``m`` below 2**64, in int64 ops (a remainder by 0 leaves
    ``v``)."""
    if m == 0:
        return v
    if m >= 1 << 63:
        # v < 2m: one subtraction where v >= m, compared with the sign bit flipped
        return torch.where((v ^ -(1 << 63)) >= m - (1 << 63), v - _signed64(m), v)
    # (v >> 1) is below 2**63: its remainder, doubled and with v's low bit added
    r = ((v >> 1) & ((1 << 63) - 1)) % m
    r = torch.where(r >= m - r, r - (m - r), r + r) + (v & 1)
    return torch.where(r >= m, r - m, r)


def _randint(key: Key, x0: torch.Tensor, x1: torch.Tensor, dtype: torch.dtype, bounds: Tuple[int, int]) -> torch.Tensor:
    """``jax.random.randint`` at the counter words ``(x0, x1)`` in int64
    torch ops."""
    nbits, lo_c, span, mult = randint_params(dtype, *bounds)
    words = [threefry2x32(fold_in(key, j), x0, x1) for j in (0, 1)]
    if nbits == 32:
        hi_b, lo_b = (y0 ^ y1 for y0, y1 in words)

        def rem(v):
            return v if span == 0 else v % span

        off = rem((((rem(hi_b) * mult) & MASK) + rem(lo_b)) & MASK)
        return (((lo_c + off + 2**31) & MASK) - 2**31).to(dtype)
    hi_b, lo_b = ((_signed32(y0).to(torch.int64) << 32) | y1 for y0, y1 in words)
    # int64 products and sums wrap modulo 2**64, as uint64's do
    off = _umod64(_umod64(hi_b, span) * _signed64(mult) + _umod64(lo_b, span), span)
    return (off + lo_c).to(dtype)


def reference_threefry(
    key: Key, n: int, *, start: int = 0, kind: str = "bits32", dtype: torch.dtype = None,
    bounds: Tuple[int, int] = None, device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """The plain version: the same function in int64 torch ops under a
    32-bit mask, on ``device``."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}: use one of {tuple(_KINDS)}")
    if start < 0 or start + n > 2**64:
        raise ValueError(f"counters [{start}, {start + n}) leave the 64-bit range")
    # the counters as int64 of the same bits (the sum wraps past 2**63)
    c = torch.arange(n, dtype=torch.int64, device=device) + _signed64(start)
    x0, x1 = (c >> 32) & MASK, c & MASK
    del c
    if kind == "randint":
        return _randint(key, x0, x1, dtype, bounds)
    y0, y1 = threefry2x32(key, x0, x1)
    if kind == "bits32":
        return _signed32(y0 ^ y1)
    if kind == "bits64":
        return (_signed32(y0).to(torch.int64) << 32) | y1
    dtype = torch.float32 if dtype is None else dtype
    return _uniform(y0, y1, dtype) if kind == "uniform" else _normal(y0, y1, dtype)


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("heat_threefry", _SOURCES).heat_threefry
        fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def threefry(
    key: Key, n: int, *, start: int = 0, kind: str = "bits32", dtype: torch.dtype = None,
    bounds: Tuple[int, int] = None, device: Union[str, torch.device] = "cpu", out: torch.Tensor = None,
) -> torch.Tensor:
    """The ``n`` elements of the stream of ``key`` from counter ``start``,
    transformed as ``kind`` says, as a flat tensor on ``device`` (into
    ``out``, a contiguous tensor of n elements, when given).  ``dtype`` is
    the output type of a uniform or normal draw (default f32) or of a
    randint draw in ``bounds`` = (low, high); bits come as int32
    (``"bits32"``) or int64 (``"bits64"``)."""
    global launches
    device = torch.device(device)
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}: use one of {tuple(_KINDS)}")
    if start < 0 or start + n > 2**64:
        raise ValueError(f"counters [{start}, {start + n}) leave the 64-bit range")
    if kind == "randint":
        otype = dtype
        if otype not in _INTS or bounds is None:
            raise TypeError(f"a randint draw needs an integer dtype and bounds, got {dtype} and {bounds}")
    else:
        otype = {"bits32": torch.int32, "bits64": torch.int64}.get(kind, torch.float32 if dtype is None else dtype)
        if kind in ("uniform", "normal") and otype not in _FLOATS:
            raise TypeError(f"the threefry kernel does not write {kind} draws of {otype}")
    if device.type == "cpu":
        res = reference_threefry(key, n, start=start, kind=kind, dtype=dtype, bounds=bounds)
        if out is None:
            return res
        out.copy_(res.view(-1))
        return out
    if device.type != "cuda":
        raise ValueError(f"threefry runs on the CPU or a CUDA device, got {device}")
    if out is None:
        out = torch.empty(n, dtype=otype, device=device)
    elif out.dtype != otype or out.numel() != n or not out.is_contiguous() or out.device.type != "cuda":
        raise ValueError(f"out must be a contiguous CUDA tensor of {n} {otype}, got {out.dtype} {tuple(out.shape)}")
    if n == 0:
        return out
    span = mult = lo = 0
    k2 = k3 = 0
    if kind == "randint":
        _, lo, span, mult = randint_params(otype, *bounds)
        (k0, k1), (k2, k3) = fold_in(key, 0), fold_in(key, 1)
    else:
        k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _kernel()(k0, k1, k2, k3, start, n, _KINDS[kind], _TYPES[otype], span, mult, lo & (2**64 - 1),
                        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


def bits32_values(key: Key, n: int) -> Sequence[int]:
    """The first ``n`` 32-bit words of ``key``'s stream as python ints,
    computed on the host (for a handful of round keys)."""
    return [int(v) & MASK for v in reference_threefry(key, n).tolist()]
