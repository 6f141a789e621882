"""The dtype lattice over torch dtypes (counterpart of heat_tpu/core/types.py).

The same class hierarchy (``datatype`` → ``bool``/``number`` →
``integer``/``floating``/``complexfloating`` → concrete types); each concrete
type exposes its backing ``torch.dtype`` through :meth:`datatype.torch_type`.
``canonical_heat_type``, ``heat_type_of``, ``promote_types`` and
``result_type`` follow the JAX package's rules exactly, so both packages
promote the same operands to the same type.
"""

from __future__ import annotations

import builtins
from typing import Any, Iterator, Type

import numpy as np
import torch

__all__ = [
    "datatype",
    "bool",
    "bool_",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "floating",
    "complexfloating",
    "complex",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int64",
    "long",
    "uint8",
    "ubyte",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex64",
    "cfloat",
    "csingle",
    "complex128",
    "cdouble",
    "flexible",
    "canonical_heat_type",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "heat_type_of",
    "issubdtype",
    "can_cast",
    "promote_types",
    "result_type",
    "iscomplex",
    "isreal",
    "finfo",
    "iinfo",
]


class datatype:
    """Base class of the dtype lattice (heat_tpu/core/types.py:81)."""

    _torch_type = None
    _char = "??"
    _nbytes = 0

    def __new__(cls, *value, device=None, comm=None, split=None):
        from . import factories

        if cls._torch_type is None:
            raise TypeError(f"cannot instantiate abstract type {cls.__name__}")
        value = value[0] if len(value) == 1 else (list(value) if value else 0)
        return factories.array(value, dtype=cls, device=device, comm=comm, split=split)

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The backing torch dtype."""
        if cls._torch_type is None:
            raise TypeError(f"abstract type {cls.__name__} has no torch dtype")
        return cls._torch_type

    @classmethod
    def char(cls) -> str:
        return cls._char

    @classmethod
    def nbytes(cls) -> builtins.int:
        return cls._nbytes


class bool(datatype):
    _torch_type = torch.bool
    _char = "u1"
    _nbytes = 1


bool_ = bool


class number(datatype):
    """Abstract numeric type."""


class integer(number):
    """Abstract integer."""


class signedinteger(integer):
    """Abstract signed integer."""


class unsignedinteger(integer):
    """Abstract unsigned integer."""


class floating(number):
    """Abstract float."""


class complexfloating(number):
    """Abstract complex."""


class flexible(datatype):
    """Abstract non-numeric type (kept for the names' sake)."""


class int8(signedinteger):
    _torch_type = torch.int8
    _char = "i1"
    _nbytes = 1


byte = int8


class int16(signedinteger):
    _torch_type = torch.int16
    _char = "i2"
    _nbytes = 2


short = int16


class int32(signedinteger):
    _torch_type = torch.int32
    _char = "i4"
    _nbytes = 4


int = int32


class int64(signedinteger):
    _torch_type = torch.int64
    _char = "i8"
    _nbytes = 8


long = int64


class uint8(unsignedinteger):
    _torch_type = torch.uint8
    _char = "u1"
    _nbytes = 1


ubyte = uint8


class float16(floating):
    _torch_type = torch.float16
    _char = "f2"
    _nbytes = 2


half = float16


class bfloat16(floating):
    _torch_type = torch.bfloat16
    _char = "bf2"
    _nbytes = 2


class float32(floating):
    _torch_type = torch.float32
    _char = "f4"
    _nbytes = 4


float = float32
float_ = float32


class float64(floating):
    _torch_type = torch.float64
    _char = "f8"
    _nbytes = 8


double = float64


class complex64(complexfloating):
    _torch_type = torch.complex64
    _char = "c8"
    _nbytes = 8


cfloat = complex64
csingle = complex64


class complex128(complexfloating):
    _torch_type = torch.complex128
    _char = "c16"
    _nbytes = 16


cdouble = complex128
# heat_tpu names the abstract complex class ``complex`` too
complex = complexfloating


# ----------------------------------------------------------------- mappings
_TORCH_TO_HEAT = {
    torch.bool: bool,
    torch.int8: int8,
    torch.int16: int16,
    torch.int32: int32,
    torch.int64: int64,
    torch.uint8: uint8,
    torch.float16: float16,
    torch.bfloat16: bfloat16,
    torch.float32: float32,
    torch.float64: float64,
    torch.complex64: complex64,
    torch.complex128: complex128,
}

_NP_TO_HEAT = {
    np.dtype(np.bool_): bool,
    np.dtype(np.int8): int8,
    np.dtype(np.int16): int16,
    np.dtype(np.int32): int32,
    np.dtype(np.int64): int64,
    np.dtype(np.uint8): uint8,
    np.dtype(np.uint16): int32,
    np.dtype(np.uint32): int64,
    np.dtype(np.uint64): int64,
    np.dtype(np.float16): float16,
    np.dtype(np.float32): float32,
    np.dtype(np.float64): float64,
    np.dtype(np.complex64): complex64,
    np.dtype(np.complex128): complex128,
}

_PY_TO_HEAT = {
    builtins.bool: bool,
    builtins.int: int64,
    builtins.float: float32,
    builtins.complex: complex64,
}


def _all_concrete() -> Iterator[Type[datatype]]:
    stack = [datatype]
    while stack:
        cls = stack.pop()
        stack.extend(cls.__subclasses__())
        if cls._torch_type is not None:
            yield cls


def canonical_heat_type(a_type: Any) -> Type[datatype]:
    """Normalize any dtype-like (heat type, python type, torch or numpy
    dtype, dtype string) to its canonical heat type."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_type is None:
            raise TypeError(f"abstract type {a_type.__name__} is not a canonical type")
        return a_type
    if isinstance(a_type, torch.dtype):
        if a_type in _TORCH_TO_HEAT:
            return _TORCH_TO_HEAT[a_type]
        raise TypeError(f"data type {a_type!r} not understood")
    if a_type in _PY_TO_HEAT:
        return _PY_TO_HEAT[a_type]
    if isinstance(a_type, str):
        for cls in _all_concrete():
            if cls.__name__ == a_type or cls._char == a_type:
                return cls
    try:
        np_dtype = np.dtype(a_type)
    except TypeError:
        raise TypeError(f"data type {a_type!r} not understood")
    if np_dtype in _NP_TO_HEAT:
        return _NP_TO_HEAT[np_dtype]
    if np_dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return bfloat16
    raise TypeError(f"data type {a_type!r} not understood")


def heat_type_of(obj: Any) -> Type[datatype]:
    """The heat type of an array-like or scalar."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    if type(obj) in _PY_TO_HEAT:
        return _PY_TO_HEAT[type(obj)]
    if hasattr(obj, "dtype"):
        return canonical_heat_type(obj.dtype)
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    raise TypeError(f"cannot infer heat type of {type(obj)}")


def heat_type_is_exact(ht_dtype: Type[datatype]) -> builtins.bool:
    """True for the integer types and bool."""
    return issubclass(ht_dtype, integer) or ht_dtype is bool


def heat_type_is_inexact(ht_dtype: Type[datatype]) -> builtins.bool:
    """True for the floating and complex types."""
    return issubclass(ht_dtype, (floating, complexfloating))


def heat_type_is_complexfloating(ht_dtype: Type[datatype]) -> builtins.bool:
    return issubclass(ht_dtype, complexfloating)


def issubdtype(arg1: Any, arg2: Any) -> builtins.bool:
    """NumPy-style subtype check over the lattice."""
    if not (isinstance(arg1, type) and issubclass(arg1, datatype)):
        arg1 = canonical_heat_type(arg1)
    if not (isinstance(arg2, type) and issubclass(arg2, datatype)):
        arg2 = canonical_heat_type(arg2)
    return issubclass(arg1, arg2)


def _cast_kind(t: Type[datatype]) -> str:
    if t is bool:
        return "b"
    if issubclass(t, unsignedinteger):
        return "u"
    if issubclass(t, signedinteger):
        return "i"
    if issubclass(t, floating):
        return "f"
    return "c"


def promote_types(type1: Any, type2: Any) -> Type[datatype]:
    """Smallest type both operands can "intuitively" cast to: same-bitlength
    promotion (int32+float32→float32, int64+float32→float64,
    int8+uint8→int16); bfloat16 meets float16 at float32."""
    a = canonical_heat_type(type1)
    b = canonical_heat_type(type2)
    if a is b:
        return a
    if {a, b} == {bfloat16, float16}:
        return float32
    ka, kb = _cast_kind(a), _cast_kind(b)
    order = "buifc"
    if order.index(ka) > order.index(kb):
        a, b, ka, kb = b, a, kb, ka
    if ka == "b":
        return b
    na, nb = a.nbytes(), b.nbytes()
    if ka == kb:
        return a if na >= nb else b
    if ka == "u" and kb == "i":
        if nb > na:
            return b
        return {1: int16, 2: int32, 4: int64}.get(na, int64)
    if kb == "f":
        if na <= nb:
            return b
        return {4: float32}.get(na, float64)
    real = max(na if ka != "c" else na // 2, nb // 2)
    return complex64 if real <= 4 else complex128


def result_type(*operands: Any) -> Type[datatype]:
    """Promotion across arrays, types and scalars: arrays > named types >
    python scalars within one kind (a scalar never widens an array of its
    own kind); across kinds the higher kind wins.  Folds from the right."""
    from .dndarray import DNDarray

    def classify(op):
        if isinstance(op, DNDarray):
            return op.dtype, 0 if op.ndim > 0 else 2
        if isinstance(op, (np.ndarray, torch.Tensor)):
            return canonical_heat_type(op.dtype), 0 if op.ndim > 0 else 2
        try:
            return canonical_heat_type(op), 1
        except TypeError:
            return heat_type_of(op), 3

    def combine(t1, p1, t2, p2):
        if t1 is t2:
            return t1, min(p1, p2)
        if p1 == p2:
            return promote_types(t1, t2), p1
        for parent in (bool, integer, floating, complexfloating):
            if issubdtype(t1, parent) and issubdtype(t2, parent):
                return (t1, min(p1, p2)) if p1 < p2 else (t2, min(p1, p2))
        order = "buifc"
        k1, k2 = order.index(_cast_kind(t1)), order.index(_cast_kind(t2))
        return (t2, min(p1, p2)) if k1 < k2 else (t1, min(p1, p2))

    if not operands:
        raise TypeError("result_type requires at least one operand")
    t, p = classify(operands[-1])
    for op in reversed(operands[:-1]):
        t2, p2 = classify(op)
        t, p = combine(t2, p2, t, p)
    return t


# numpy's cast rules over the lattice; numpy has no bfloat16, so its pairs
# follow the table that ml_dtypes registers with numpy (heat_tpu asks numpy
# with ml_dtypes' type)
_NP_OF = {
    bool: np.dtype(np.bool_), int8: np.dtype(np.int8), int16: np.dtype(np.int16), int32: np.dtype(np.int32),
    int64: np.dtype(np.int64), uint8: np.dtype(np.uint8), float16: np.dtype(np.float16),
    float32: np.dtype(np.float32), float64: np.dtype(np.float64), complex64: np.dtype(np.complex64),
    complex128: np.dtype(np.complex128),
}
_BF16_WIDER = (bfloat16, float32, float64, complex64, complex128)
_BF16_CASTS = {  # casting -> (types that cast to bfloat16, types bfloat16 casts to)
    "no": ((bfloat16,), (bfloat16,)),
    "equiv": ((bfloat16,), (bfloat16,)),
    "safe": ((bool, int8, uint8, bfloat16), _BF16_WIDER),
    "same_kind": (None, _BF16_WIDER),
    "unsafe": (None, None),
}


def _np_can_cast(a: Type[datatype], b: Type[datatype], casting: str) -> builtins.bool:
    if bfloat16 not in (a, b):
        return builtins.bool(np.can_cast(_NP_OF[a], _NP_OF[b], casting=casting))
    if casting not in _BF16_CASTS:
        raise ValueError(f"casting must be one of 'no', 'equiv', 'safe', 'same_kind' or 'unsafe', got {casting!r}")
    into, outof = _BF16_CASTS[casting]
    allowed = into if b is bfloat16 else outof
    return allowed is None or (a if b is bfloat16 else b) in allowed


def can_cast(from_: Any, to: Any, casting: str = "intuitive") -> builtins.bool:
    """Whether ``from_`` (a type, or a scalar or array whose type is taken)
    casts to ``to`` under ``casting``: numpy's ``"no"``, ``"equiv"``,
    ``"safe"``, ``"same_kind"``, ``"unsafe"``, or the default
    ``"intuitive"``: what ``"safe"`` allows plus an integer to a float or
    complex type of at least its bit length (int32 to float32)."""
    if not isinstance(from_, type):
        try:
            from_ = heat_type_of(from_)
        except TypeError:
            from_ = canonical_heat_type(from_)
    else:
        from_ = canonical_heat_type(from_)
    to = canonical_heat_type(to)
    if casting == "intuitive":
        if _np_can_cast(from_, to, "safe"):
            return True
        to_bits = to.nbytes() // 2 if _cast_kind(to) == "c" else to.nbytes()
        return _cast_kind(from_) in ("u", "i") and _cast_kind(to) in ("f", "c") and to_bits >= from_.nbytes()
    return _np_can_cast(from_, to, casting)


def iscomplex(x):
    """Elementwise: True where the imaginary part is nonzero (False for
    every element of a real array)."""
    from . import _operations

    return _operations._local_op(
        lambda t: t.imag != 0 if t.is_complex() else torch.zeros_like(t, dtype=torch.bool), x, no_cast=True
    )


def isreal(x):
    """Elementwise: True where the imaginary part is zero (True for every
    element of a real array)."""
    from . import _operations

    return _operations._local_op(
        lambda t: t.imag == 0 if t.is_complex() else torch.ones_like(t, dtype=torch.bool), x, no_cast=True
    )


class finfo:
    """Machine limits of a floating type: ``bits``, ``eps``, ``max``,
    ``min``, ``tiny`` and ``resolution`` as python numbers; a complex type
    gives those of its parts.  Read from ``torch.finfo``, which knows
    bfloat16 too."""

    def __new__(cls, ht_dtype):
        ht_dtype = canonical_heat_type(ht_dtype)
        if not issubclass(ht_dtype, (floating, complexfloating)):
            raise TypeError(f"data type {ht_dtype} not inexact")
        tt = {complex64: torch.float32, complex128: torch.float64}.get(ht_dtype, ht_dtype.torch_type())
        info = torch.finfo(tt)
        obj = object.__new__(cls)
        obj.bits = info.bits
        obj.eps = builtins.float(info.eps)
        obj.max = builtins.float(info.max)
        obj.min = builtins.float(info.min)
        obj.tiny = builtins.float(info.tiny)
        # numpy's resolution is 10 ** -precision rounded to the type
        obj.resolution = builtins.float(torch.tensor(info.resolution, dtype=tt).item())
        return obj


class iinfo:
    """Machine limits of an integer type (or bool): ``bits``, ``max`` and
    ``min`` as python ints."""

    def __new__(cls, ht_dtype):
        ht_dtype = canonical_heat_type(ht_dtype)
        if not issubclass(ht_dtype, integer) and ht_dtype is not bool:
            raise TypeError(f"data type {ht_dtype} not integral")
        obj = object.__new__(cls)
        if ht_dtype is bool:
            obj.bits, obj.max, obj.min = 8, 1, 0
        else:
            info = torch.iinfo(ht_dtype.torch_type())
            obj.bits, obj.max, obj.min = info.bits, builtins.int(info.max), builtins.int(info.min)
        return obj
