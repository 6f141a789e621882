"""Lazy op chains and their program cache (counterpart of
heat_tpu/core/fusion.py).

The op workhorses of :mod:`~heat_tpu_torch.core._operations` (elementwise
binary and unary ops, ``where=`` masks, reductions, scans, dtype casts) and
the composites registered beside them (``mean``/``var``/``std``, the
moments, the Euclidean ``cdist``) do not run when they are called: each
builds one :class:`Expr` node of a DAG, and the result is a
:class:`LazyDNDarray` whose metadata (shape, dtype, split) is exact at once.
The DAG runs at a materialization boundary: any read of the array's shards
(``.larray``, ``.shards``, ``numpy()``, ``__bool__``, printing, a layout
change, an ``out=`` target), which funnels through
:meth:`LazyDNDarray.__getattr__`, or :func:`materialize` /
:func:`materialize_all`, which run several roots as one program.

A *program* is the deduplicated, linearized instruction list of
:func:`_linearize`: a subtree shared between roots, by node identity or by
structure, is computed once (counted as ``cse_hits``).  Programs are cached
under the fingerprint of that list, the leaves' signatures (shape, dtype,
split, mesh) and the guard state; scalars enter as 0-d leaves, never as
constants, so a chain re-run with another scalar is a cache hit.  The
counters (``hits``, ``misses``, ``evictions``, ``cse_hits``,
``fallbacks`` by reason, ``roots_per_program``) keep heat_tpu's keys in the
``fusion`` telemetry group.

Where the port differs from heat_tpu's engine:

* No cross-op kernel is generated and no HLO exists.  A program is
  evaluated op by op with the same torch calls the eager path makes
  (``fuse(False)``), so its values are bitwise the eager ones; each
  intermediate is freed after its last consumer, so a chain's peak is its
  leaves, its outputs and the intermediates still to be read.
  :func:`last_hlo` returns the rendering of the last program's list.
* No eager rescue: an op that raises inside a program raises.  heat_tpu's
  ``compile_error``/``exec_error`` fallbacks keep their keys at 0;
  ``unfusable`` and ``guard_replay`` count as in heat_tpu.
* Node metadata is predicted by running the eager op on meta tensors (the
  counterpart of ``jax.eval_shape``), memoized on (op, input metadata,
  static kwargs).
* ``donate=`` has no counterpart: callers drop their references.  The pins
  (:func:`safe_to_donate`) still keep ``resplit_`` from tagging a buffer
  that a pending chain reads as donated.
* The port's arrays, unlike JAX's, are written in place, and a pending
  chain reads its leaves when it runs.  So a chain keeps the values its
  leaves had when it was built, as the eager path would:

  - an in-place write through the package (``__setitem__``,
    ``fill_diagonal``) first gives the pending leaves on that storage a
    copy of the old values (:func:`before_write`);
  - storage that code outside the package can write is *exposed*
    (:func:`expose`): a tensor handed out by ``.larray``, ``.shards`` or
    ``lloc``, the caller's tensor behind ``array(..., copy=False)``, a
    tensor or numpy operand.  Handing it out gives the pending leaves on it
    a copy, and a later leaf over it snapshots (clones) its values, except
    inside :func:`sealed`, where a library call builds a chain and
    materializes it before any outside code runs;
  - each leaf keeps its tensors' version counters, and a materialization
    raises rather than read a leaf that was written by a route the engine
    does not see.
* A matcher that raises, raises: heat_tpu's ``_lower_terminated`` swallows
  a terminator's exception and takes the generic program; the port has no
  eager rescue (:func:`register_terminator`).

A 2-D ``linalg.matmul`` is a node of the overlap engine
(``parallel/overlap.py``): at a cache miss of a single-root chain
``tail(... (a @ b))`` the registered terminator returns one ring schedule
with the elementwise tail applied to its result, which the cache keeps as
the chain's program.

The guard (``HEAT_TPU_GUARD``, :mod:`~heat_tpu_torch.core.guard`): while it
is on, every node records the user source line that built it (kept out of
the fingerprint, so guarding adds no cache misses), and each
materialization costs one ``isfinite`` reduction over the float outputs
plus one host read of its flag.  A program whose finite leaves produced
NaN/Inf is replayed op by op to name the first op that produced it, its
line and its subtree (:class:`NonFiniteError` in ``raise`` mode, a
:class:`NonFiniteWarning` in ``warn`` mode), counted as ``guard_replay``.
In ``raise`` mode, and off the card, the flag is read at once.  In ``warn``
mode on the card it is copied to the host without waiting and read once
its copy has landed: at a later materialization, at a host read of an
array (``numpy()``, ``item()``), or when more than ``_DEFER_MAX`` checks
wait, so the warning may come after the call that made the value.  With
the guard off, or in ``warn`` mode on the card, a materialization never
waits on the card.

``HEAT_TPU_FUSE=off`` (or ``0``/``false``/``no``) restores eager execution;
:func:`fuse` is the scoped switch.
"""

from __future__ import annotations

import functools
import os
import threading
import time
import warnings
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import envparse, guard, memtrack, telemetry
from ..analysis import program_audit, sanitize
from .dndarray import DNDarray
from .guard import NonFiniteError

__all__ = [
    "LazyDNDarray",
    "NonFiniteError",
    "Unfusable",
    "before_write",
    "cache_stats",
    "cast_node",
    "count_fallback",
    "defer",
    "describe",
    "drain_guard",
    "enabled",
    "expose",
    "fuse",
    "last_hlo",
    "leaf",
    "leaf_from",
    "materialize",
    "materialize_all",
    "materialize_resplit",
    "node",
    "op_name",
    "pin_leaks",
    "register_cache_salt",
    "register_op",
    "register_split_terminator",
    "register_terminator",
    "reset_cache",
    "safe_to_donate",
    "sealed",
    "set_enabled",
]


# --------------------------------------------------------------- env switch

def _env_enabled() -> bool:
    return os.environ.get("HEAT_TPU_FUSE", "on").strip().lower() not in ("off", "0", "false", "no")


_ENABLED = _env_enabled()

# per-thread state: ``eager`` counts the engine's own op-by-op runs on this
# thread (a program's run, a replay, a metadata probe), inside which every
# op evaluates eagerly; ``sealed`` counts :func:`sealed` scopes.  Serving
# replicas run their steps on threads of their own, so neither may leak
# from one thread into another the way a module global would.
_LOCAL = threading.local()


def enabled() -> bool:
    """Whether the lazy engine is active on this thread (``HEAT_TPU_FUSE``,
    default on; off inside the engine's own op-by-op runs)."""
    return _ENABLED and not getattr(_LOCAL, "eager", 0)


@contextmanager
def _eager():
    """Evaluate eagerly on this thread (the engine's own runs)."""
    _LOCAL.eager = getattr(_LOCAL, "eager", 0) + 1
    try:
        yield
    finally:
        _LOCAL.eager -= 1


def set_enabled(flag: bool) -> bool:
    """Switch the engine on or off; returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


@contextmanager
def fuse(flag: bool = True):
    """Scoped :func:`set_enabled` (``with fusion.fuse(False): ...``)."""
    prev = set_enabled(flag)
    try:
        yield
    finally:
        set_enabled(prev)


class Unfusable(Exception):
    """Raised while building a node when the op cannot enter the DAG
    (unhashable static kwargs, metadata prediction failed, mixed meshes).
    Callers take the eager path, which succeeds or raises the user-facing
    error."""


# ----------------------------------------------------------------- op table
# Display name and kind of the functions that enter the DAG.  Fingerprints
# key on the function OBJECT; the table only names it.  A node of one of
# the generic appliers of _operations carries its torch operation as the
# static kwarg ``op``, and is named and kinded by that operation.

_OP_TABLE: "dict[Callable, Tuple[str, str]]" = {}


def register_op(fn: Callable, name: str, kind: str = "elementwise") -> Callable:
    """Record display metadata for ``fn`` (kinds: ``elementwise``, ``cast``,
    ``comparison``, ``predicate``, ``reduction``, ``scan``, ``composite``)."""
    _OP_TABLE[fn] = (name, kind)
    return fn


def _meta(fn: Callable, kw=None) -> Tuple[str, str]:
    if kw:
        for k, v in kw:
            if k == "op":
                meta = _OP_TABLE.get(v)
                kind = _OP_TABLE.get(fn, (None, "elementwise"))[1]
                if meta is not None:
                    return meta[0], meta[1]
                return getattr(v, "__name__", repr(v)), kind
    meta = _OP_TABLE.get(fn)
    if meta is not None:
        return meta
    return getattr(fn, "__name__", repr(fn)), "elementwise"


def op_name(fn: Callable, kw=None) -> str:
    """Display name of ``fn`` (of its ``op`` kwarg for a generic applier)."""
    return _meta(fn, kw)[0]


# -------------------------------------------------------------- buffer pins
# id(tensor) -> live-pin count: some pending Expr leaf holds this exact
# tensor.  _PIN_STORAGE counts the same pins by storage, so an in-place
# write through any view of a pinned buffer is seen (before_write).

_PINNED: "dict[int, int]" = {}
_PIN_OWNERS: "dict[int, list]" = {}
_PIN_STORAGE: "dict[int, int]" = {}


def _tensors(value):
    """The distinct tensors of a leaf value (a DNDarray's shards, or one
    tensor)."""
    if isinstance(value, DNDarray):
        seen, out = set(), []
        for s in value._DNDarray__shards:
            if id(s) not in seen:
                seen.add(id(s))
                out.append(s)
        return out
    return [value]


def _storage_ptr(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def _unpin(buf_ids, ptrs) -> None:
    for buf_id in buf_ids:
        n = _PINNED.get(buf_id, 0) - 1
        owners = _PIN_OWNERS.get(buf_id)
        if owners:
            for i, r in enumerate(owners):
                if r() is None:
                    del owners[i]
                    break
            else:
                owners.pop()
            if not owners:
                _PIN_OWNERS.pop(buf_id, None)
        if n > 0:
            _PINNED[buf_id] = n
        else:
            _PINNED.pop(buf_id, None)
    for p in ptrs:
        n = _PIN_STORAGE.get(p, 0) - 1
        if n > 0:
            _PIN_STORAGE[p] = n
        else:
            _PIN_STORAGE.pop(p, None)


def _pin(expr: "Expr", value) -> None:
    ts = _tensors(value)
    ids = [id(t) for t in ts]
    ptrs = [p for p in (_storage_ptr(t) for t in ts) if p]
    for buf_id in ids:
        _PINNED[buf_id] = _PINNED.get(buf_id, 0) + 1
        _PIN_OWNERS.setdefault(buf_id, []).append(weakref.ref(expr))
    for p in ptrs:
        _PIN_STORAGE[p] = _PIN_STORAGE.get(p, 0) + 1
    weakref.finalize(expr, _unpin, ids, ptrs)
    for t in ts:
        memtrack.tag_buffer(t, "pinned")


def pin_leaks() -> "list[dict]":
    """Pins whose owning Exprs are (partly) gone: a shortfall of live
    owners against the pin count means an Expr died without its finalize
    releasing the pin.  Empty in a healthy process."""
    out = []
    for buf_id, count in _PINNED.items():
        live = sum(1 for r in _PIN_OWNERS.get(buf_id, ()) if r() is not None)
        if live < count:
            out.append({"buf_id": buf_id, "pins": count, "live_owners": live})
    return out


def safe_to_donate(value) -> bool:
    """False iff a pending expression still reads ``value`` (a tensor, a
    list of shards or a DNDarray) as a leaf."""
    if isinstance(value, DNDarray):
        value = value.shards
    ts = value if isinstance(value, (list, tuple)) else [value]
    return not any(id(t) in _PINNED for t in ts)


def before_write(shards) -> None:
    """Called before an in-place write into ``shards``: every pending leaf
    that reads the same storage is given a copy of the values it was built
    on, so the chain computes what the eager path would have."""
    if not _PIN_STORAGE:
        return
    ptrs = {p for p in (_storage_ptr(s) for s in shards) if p and p in _PIN_STORAGE}
    if not ptrs:
        return
    done = set()
    for owners in list(_PIN_OWNERS.values()):
        for r in owners:
            e = r()
            if e is None or id(e) in done or e.value is None:
                continue
            if not any(_storage_ptr(t) in ptrs for t in _tensors(e.value)):
                continue
            done.add(id(e))
            e.value = _copied(e.value)
            e.vers = _versions(e.value)
            e.src = None


def _copied(value):
    if not isinstance(value, DNDarray):
        return value.clone()
    return DNDarray._unledgered(_cloned(value._DNDarray__shards), value.gshape, value.dtype, value.split,
                                value.device, value.comm)


def _cloned(shards) -> list:
    """Clones of ``shards``; a tensor repeated (a replicated array) is
    cloned once."""
    copies = {}
    return [copies.setdefault(id(s), s.clone()) for s in shards]


# ------------------------------------------------------------ exposed storage
# data_ptr -> weak reference to the storage handed out (its Python object
# lives as long as the storage does, so the entry dies with it and a reused
# address is not taken for the old storage).  Where a torch build does not
# keep a storage's Python object, the entry is True and never dies: a stale
# address then costs a needless snapshot, never a missed one.

def _storage_objects_kept() -> bool:
    t = torch.empty(1)
    return t.untyped_storage() is t.untyped_storage()


_WEAK_STORAGE = _storage_objects_kept()
_EXPOSED: "dict[int, object]" = {}


def _unexpose(ptr, ref) -> None:
    if _EXPOSED.get(ptr) is ref:
        del _EXPOSED[ptr]


def expose(tensors) -> None:
    """``tensors`` are being handed to code outside the package, which can
    write them without the engine seeing it: pending leaves on their
    storage get a copy of their values now, and later leaves on it snapshot
    theirs (see :func:`leaf_from`)."""
    before_write(tensors)
    for t in tensors:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue
        p = st.data_ptr()
        if not p:
            continue
        if not _WEAK_STORAGE:
            _EXPOSED[p] = True
            continue
        old = _EXPOSED.get(p)
        if old is None or old() is not st:
            _EXPOSED[p] = weakref.ref(st, functools.partial(_unexpose, p))


def _is_exposed(t: torch.Tensor) -> bool:
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return False
    r = _EXPOSED.get(st.data_ptr())
    return r is True or (r is not None and r() is st)


@contextmanager
def sealed():
    """A library call that builds a chain and materializes it before it
    returns: no code outside the package runs in between, so leaves over
    exposed storage need no snapshot inside it."""
    _LOCAL.sealed = getattr(_LOCAL, "sealed", 0) + 1
    try:
        yield
    finally:
        _LOCAL.sealed -= 1


def _versions(value) -> tuple:
    """The version counters of a leaf value's tensors (None for an
    inference tensor, which keeps none and cannot be written outside
    inference mode)."""
    out = []
    for t in _tensors(value):
        try:
            out.append(t._version)
        except RuntimeError:
            out.append(None)
    return tuple(out)


def _check_unwritten(leaves) -> None:
    """Refuse to run a program whose leaf was written in place after the
    chain was built, by a route the engine does not see (the chain would
    read the new values, which the eager path would not have)."""
    for lf in leaves:
        if lf.vers is not None and _versions(lf.value) != lf.vers:
            raise RuntimeError(
                "a tensor that a pending fused chain reads was written in place after the chain was built; "
                "materialize the chain before the write (fusion.materialize), or run under fusion.fuse(False)"
            )


# ------------------------------------------------------------------ op-DAG

class Aval(NamedTuple):
    """Metadata of a node's value: a DNDarray (``array``) of global
    ``shape``, torch ``dtype`` and ``split``, or a plain tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    split: Optional[int]
    array: bool


class Expr:
    """One node of the lazy DAG.

    Leaf: ``value`` is a concrete DNDarray (a snapshot sharing the shards of
    the array it was built from) or a tensor (a scalar or a replicated
    operand).  Op node: ``fn`` applied to ``args`` with static ``kwargs``;
    ``aval`` is the predicted result.  Materialization *leafifies* the node
    in place, so a diamond never recomputes a subchain.  ``site`` is the
    user source line that built the node (the guard's provenance; never
    part of the cache key)."""

    __slots__ = ("fn", "args", "kwargs", "aval", "value", "lshape", "site", "vers", "src", "__weakref__")

    def __init__(self, fn, args, kwargs, aval, value=None, lshape=None, site=None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.aval = aval
        self.value = value
        self.lshape = lshape
        self.site = site
        # a leaf: its tensors' version counters, and the array's shards it
        # was built from (weak references; leaf_from's cache key)
        self.vers = None if value is None else _versions(value)
        self.src = None

    def leafify(self, value, lshape) -> None:
        self.value = value
        self.lshape = tuple(lshape)
        self.fn = None
        self.args = ()
        self.kwargs = None
        self.vers = _versions(value)


def _aval_of(value) -> Aval:
    if isinstance(value, DNDarray):
        return Aval(tuple(value.gshape), value._DNDarray__shards[0].dtype, value.split, True)
    return Aval(tuple(value.shape), value.dtype, None, False)


def leaf(value, lshape=None, pin: bool = False) -> Expr:
    """Wrap a concrete DNDarray or tensor as a DAG leaf."""
    aval = _aval_of(value)
    lshape = aval.shape if lshape is None else tuple(lshape)
    e = Expr(None, (), None, aval, value=value, lshape=lshape)
    if pin:
        _pin(e, value)
    return e


def _pending(x) -> bool:
    return isinstance(x, LazyDNDarray) and "_DNDarray__shards" not in x.__dict__


def leaf_from(x: DNDarray) -> Expr:
    """Leaf (or pending sub-DAG) for a DNDarray operand: a lazy array gives
    its expression, a concrete one a pinned leaf over its shards, or over a
    snapshot of them where their storage is exposed (outside
    :func:`sealed`).  One leaf serves the array while its shards stay the
    same tensors, unwritten."""
    if _pending(x):
        e = x._expr
        if e is not None:
            return e
    if x.comm.is_process_comm:
        raise Unfusable("the comm spans processes")
    shards = x._DNDarray__shards
    snap = not getattr(_LOCAL, "sealed", 0) and bool(_EXPOSED) and any(_is_exposed(s) for s in shards)
    cached = x.__dict__.get("_fusion_leaf")
    if cached is not None:
        e = cached[0]()
        if (e is not None and e.src is not None and len(e.src) == len(shards)
                and all(r() is t for r, t in zip(e.src, shards))
                and cached[1] == _versions(x) and (cached[2] or not snap)):
            return e
    value = DNDarray._unledgered(_cloned(shards) if snap else shards, x.gshape, x.dtype, x.split, x.device, x.comm)
    e = leaf(value, pin=True)
    e.src = tuple(weakref.ref(t) for t in shards)
    x.__dict__["_fusion_leaf"] = (weakref.ref(e), _versions(x), snap)
    return e


def _kwargs_key(kwargs) -> tuple:
    if not kwargs:
        return ()
    try:
        items = tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))
        hash(items)
    except TypeError as err:
        raise Unfusable(f"unhashable static kwargs: {kwargs!r}") from err
    return items


# Metadata prediction: the eager op run on meta tensors (shapes and dtypes,
# no data), memoized on (fn, child avals, kwargs, mesh size).  LRU-capped.
_AVAL_MEMO: "OrderedDict[tuple, Aval]" = OrderedDict()
_AVAL_MEMO_MAX = 4096


# the planes _quiet silences are process-wide: one thread's save and
# restore must not interleave with another's
_QUIET_LOCK = threading.RLock()


@contextmanager
def _quiet():
    """Eager evaluation with every plane that observes a run silenced: the
    metadata probe must leave no trace in the ledgers, the injectors or the
    sanitizer's chain."""
    with _QUIET_LOCK, _eager():
        prev = (telemetry._LEVEL, memtrack._ENABLED[0], sanitize._ENABLED_OVERRIDE[0], guard._INJECTOR)
        telemetry._LEVEL = 0
        memtrack._ENABLED[0] = False
        sanitize._ENABLED_OVERRIDE[0] = False
        guard._INJECTOR = None
        try:
            yield
        finally:
            telemetry._LEVEL = prev[0]
            memtrack._ENABLED[0] = prev[1]
            sanitize._ENABLED_OVERRIDE[0] = prev[2]
            guard._INJECTOR = prev[3]


def _probe_value(a: Aval, device, comm):
    if not a.array:
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if a.split is None:
        shards = [torch.empty(a.shape, dtype=a.dtype, device="meta")] * comm.size
    else:
        shards = [torch.empty(comm.chunk(a.shape, a.split, rank=r)[1], dtype=a.dtype, device="meta")
                  for r in range(comm.size)]
    from . import types

    return DNDarray._unledgered(shards, a.shape, types.canonical_heat_type(a.dtype), a.split, device, comm)


_META_READY = [False]


def _warm_meta() -> None:
    """The process's first call of a meta kernel imports torch's compiler
    stack, and that import keeps its calling frames alive for good: run it
    once on a thread of its own, so that no frame holding the caller's
    nodes (and their pins) is among them."""
    if not _META_READY[0]:
        t = threading.Thread(target=torch.lt, args=(torch.empty(1, device="meta"), 0.0), daemon=True)
        t.start()
        t.join()
        _META_READY[0] = True


def _infer_aval(fn, child_avals, kw_key, device, comm) -> Aval:
    key = (fn, tuple(child_avals), kw_key, comm.size)
    try:
        out = _AVAL_MEMO[key]
        _AVAL_MEMO.move_to_end(key)
        return out
    except KeyError:
        pass
    except TypeError as err:
        raise Unfusable(f"unhashable op {fn!r}") from err
    _warm_meta()
    try:
        with _quiet():
            probes = [_probe_value(a, device, comm) for a in child_avals]
            res = fn(*probes, **dict(kw_key))
    except Exception as err:
        raise Unfusable(f"metadata prediction failed for {op_name(fn, kw_key)}: {err}") from err
    if isinstance(res, DNDarray):
        out = Aval(tuple(res.gshape), res._DNDarray__shards[0].dtype, res.split, True)
    elif isinstance(res, torch.Tensor):
        out = Aval(tuple(res.shape), res.dtype, None, False)
    else:
        raise Unfusable(f"{op_name(fn, kw_key)} does not return a single array")
    _AVAL_MEMO[key] = out
    if len(_AVAL_MEMO) > _AVAL_MEMO_MAX:
        _AVAL_MEMO.popitem(last=False)
    return out


def node(fn: Callable, args: Tuple[Expr, ...], ctx, **kwargs) -> Expr:
    """Apply ``fn`` lazily to child nodes with static ``kwargs``; ``ctx`` is
    the (Device, MeshComm) pair the result lives on.  With the guard on, the
    user source line that built the op rides along."""
    if ctx[1].is_process_comm:
        # a program runs within one process: process comms stay eager
        raise Unfusable("the comm spans processes")
    kw_key = _kwargs_key(kwargs)
    aval = _infer_aval(fn, tuple(a.aval for a in args), kw_key, ctx[0], ctx[1])
    site = guard.capture_site(2) if guard.enabled() else None
    return Expr(fn, tuple(args), kw_key, aval, site=site)


def _astype(x, dtype):
    return x.astype(dtype)


register_op(_astype, "astype", kind="cast")


def cast_node(child: Expr, dtype, ctx) -> Expr:
    """Lazy dtype cast to the heat type ``dtype`` (no-op when it matches)."""
    if child.aval.dtype == dtype.torch_type():
        return child
    return node(_astype, (child,), ctx, dtype=dtype)


def _render_instrs(instrs, leaf_avals, out_slots, upto=None, mark=None) -> str:
    """Renderer behind :func:`describe`, :func:`last_hlo` and the guard's
    offending-subtree report.  A slot consumed more than once renders once,
    tagged ``<<shared xN>>``; ``upto`` truncates after that slot and
    ``mark`` annotates it."""
    if isinstance(out_slots, int):
        out_slots = (out_slots,)
    refs: "dict[int, int]" = {}
    for ins in instrs:
        if ins[0] == "O":
            for c in ins[3]:
                refs[c] = refs.get(c, 0) + 1
    for s in out_slots:
        refs[s] = refs.get(s, 0) + 1
    last = len(instrs) - 1 if upto is None else int(upto)
    lines = []
    for i, ins in enumerate(instrs[: last + 1]):
        if ins[0] == "L":
            a = leaf_avals[ins[1]]
            line = f"%{i} = leaf{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}"
        else:
            _, fn, kw, ch = ins
            shown = {k: v for k, v in (kw or ()) if k not in ("op", "no_cast")}
            kws = f" {shown}" if shown else ""
            line = f"%{i} = {op_name(fn, kw)}({', '.join('%%%d' % c for c in ch)}){kws}"
        if refs.get(i, 0) > 1:
            line += f"   <<shared x{refs[i]}>>"
        if mark is not None and i == mark:
            line += "   <-- first non-finite"
        lines.append(line)
    if upto is None:
        lines.append("return " + ", ".join(f"%{s}" for s in out_slots))
    else:
        lines.append(f"return %{last}")
    return "\n".join(lines)


def describe(*exprs) -> str:
    """Postorder rendering of one or more DAG roots (Exprs or DNDarrays) as
    the ONE deduplicated instruction list :func:`materialize_all` would run,
    shared subtrees marked ``<<shared xN>>``."""
    roots = []
    for e in exprs:
        if isinstance(e, Expr):
            roots.append(e)
        elif isinstance(e, DNDarray):
            roots.append(leaf_from(e))
        else:
            raise TypeError(f"describe() takes Expr or DNDarray, got {type(e)}")
    instrs, _, leaves, out_slots = _linearize(*roots)
    return _render_instrs(instrs, [lf.aval for lf in leaves], out_slots)


# ----------------------------------------------------------- linearization

def _leaf_key(value) -> tuple:
    if isinstance(value, DNDarray):
        return ("d", tuple(id(s) for s in value._DNDarray__shards), value.split, tuple(value.gshape))
    return ("t", id(value))


def _linearize(*roots: Expr):
    """:func:`_walk` without the per-slot avals."""
    return _walk(*roots)[:4]


def _walk(*roots: Expr):
    """Postorder-linearize one or more roots into ``(instrs, sites, leaves,
    out_slots)`` (heat_tpu :408).  Leaves become ``("L", leaf_index)``, op
    nodes ``("O", fn, kwargs_key, child_slots)``; all roots share one list.
    Two-level deduplication: node identity (a diamond, or several roots
    over one producer) and structure (distinct op nodes with the same fn,
    kwargs and child slots); every op-node reuse counts a ``cse_hit``.
    Two leaves over the same shards collapse to one input.  ``sites`` is
    the parallel provenance, kept out of ``instrs``; ``avals`` the
    per-slot metadata."""
    instrs = []
    sites = []
    avals = []
    leaves = []
    slot: "dict[int, int]" = {}
    leaf_slot: "dict[tuple, int]" = {}
    struct_slot: "dict[tuple, int]" = {}
    keepalive = []

    def visit(n: Expr) -> int:
        nid = id(n)
        hit = slot.get(nid)
        if hit is not None:
            if instrs[hit][0] == "O":
                _STATS["cse_hits"] += 1
            return hit
        keepalive.append(n)
        if n.value is not None:
            lk = _leaf_key(n.value)
            if lk in leaf_slot:
                slot[nid] = leaf_slot[lk]
                return slot[nid]
            leaves.append(n)
            instrs.append(("L", len(leaves) - 1))
            sites.append(n.site)
            avals.append(n.aval)
            leaf_slot[lk] = len(instrs) - 1
        else:
            ch = tuple(visit(c) for c in n.args)
            sk = (n.fn, n.kwargs, ch)
            hit = struct_slot.get(sk)
            if hit is not None:
                _STATS["cse_hits"] += 1
                slot[nid] = hit
                return hit
            instrs.append(("O", n.fn, n.kwargs, ch))
            sites.append(n.site)
            avals.append(n.aval)
            struct_slot[sk] = len(instrs) - 1
        slot[nid] = len(instrs) - 1
        return slot[nid]

    out_slots = tuple(visit(r) for r in roots)
    # visit's closure cell refers to visit: unbind it, so the nodes it kept
    # alive (and their pins) go with the caller's references, not with the
    # next cyclic collection
    visit = None  # noqa: F841
    return tuple(instrs), tuple(sites), leaves, out_slots, avals


class _Program:
    """One cache entry: the instruction list, its roots, and for each slot
    the instruction after which no consumer reads it (intermediates are
    dropped there)."""

    __slots__ = ("instrs", "out_slots", "leaf_avals", "free_after", "hits", "fp", "custom")

    def __init__(self, instrs, out_slots, leaf_avals, custom=None):
        self.custom = custom
        self.instrs = instrs
        self.out_slots = out_slots
        self.leaf_avals = leaf_avals
        last = {}
        for i, ins in enumerate(instrs):
            if ins[0] == "O":
                for c in ins[3]:
                    last[c] = i
        keep = set(out_slots)
        free = [[] for _ in instrs]
        for s, i in last.items():
            if s not in keep:
                free[i].append(s)
        self.free_after = tuple(tuple(f) for f in free)
        self.hits = 0
        self.fp = None

    def run(self, vals):
        """Evaluate op by op with the eager torch calls (or run the
        terminator's program); returns one value per root."""
        with _eager():
            if self.custom is not None:
                return (self.custom(vals),)
            env = [None] * len(self.instrs)
            for i, ins in enumerate(self.instrs):
                if ins[0] == "L":
                    env[i] = vals[ins[1]]
                    continue
                _, fn, kw, ch = ins
                env[i] = fn(*[env[c] for c in ch], **dict(kw))
                for s in self.free_after[i]:
                    env[s] = None
            return tuple(env[s] for s in self.out_slots)


# ------------------------------------------------------------ program cache

_CACHE: "OrderedDict[tuple, _Program]" = OrderedDict()
_CACHE_MAX = envparse.env_int("HEAT_TPU_FUSE_CACHE_SIZE", 4096)
_STATS = telemetry.register_group(
    "fusion",
    {
        "hits": 0, "misses": 0, "evictions": 0, "fallbacks": 0,
        "cse_hits": 0,
        "fallback_reasons": {
            "unfusable": 0, "compile_error": 0, "exec_error": 0,
            "guard_replay": 0,
        },
        "roots_per_program": {},
    },
    extra=lambda: {"size": len(_CACHE)},
)
_FALLBACK_REASONS = _STATS["fallback_reasons"]
_ROOTS_PER_PROGRAM = _STATS["roots_per_program"]


def cache_stats() -> dict:
    """The program cache's counters (heat_tpu's keys): ``hits``/``misses``
    (lookups), ``size`` (live entries), ``evictions`` (LRU drops past
    ``HEAT_TPU_FUSE_CACHE_SIZE``), ``cse_hits`` (subtree reuse during
    linearization), ``fallbacks`` with ``fallback_reasons``, and
    ``roots_per_program`` (roots of each program at its miss).  The same
    counters appear in ``telemetry.snapshot()``."""
    return telemetry.snapshot_group("fusion")


def reset_cache() -> None:
    """Drop every program and zero the counters."""
    _CACHE.clear()
    telemetry.reset_group("fusion")


def count_fallback(reason: str = "unfusable") -> None:
    _STATS["fallbacks"] += 1
    _FALLBACK_REASONS[reason] = _FALLBACK_REASONS.get(reason, 0) + 1
    telemetry.record_event("fallback", reason=reason)


def last_hlo() -> Optional[str]:
    """The rendering of the most recently used program's instruction list
    (the port generates no HLO).  None when the cache is empty."""
    if not _CACHE:
        return None
    p = next(reversed(_CACHE.values()))
    return _render_instrs(p.instrs, p.leaf_avals, p.out_slots)


def _program_fingerprint(instrs, out_slots) -> str:
    """Digest of the program's topology for the telemetry ledger: display
    names, static kwargs, child slots and roots."""
    parts = []
    for ins in instrs:
        if ins[0] == "L":
            parts.append(f"L{ins[1]}")
        else:
            kw = tuple((k, v) for k, v in (ins[2] or ()) if k != "op")
            parts.append(f"{op_name(ins[1], ins[2])}{kw}>{ins[3]}")
    parts.append(f"->{out_slots}")
    return telemetry.fingerprint(parts)


def _nelems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _estimate_cost(instrs, avals, out_slots):
    """``(ops, flops, bytes)`` for the ledger: one operation per output
    element of an elementwise/cast/comparison/predicate op, per input
    element of a reduction/scan/composite; bytes are each leaf read once
    and each root written once."""
    n_ops, flops, hbm = 0, 0.0, 0.0
    for i, ins in enumerate(instrs):
        if ins[0] == "L":
            hbm += _nelems(avals[i].shape) * avals[i].dtype.itemsize
            continue
        n_ops += 1
        _, fn, kw, ch = ins
        if _meta(fn, kw)[1] in ("reduction", "composite", "scan"):
            flops += float(sum(_nelems(avals[c].shape) for c in ch))
        else:
            flops += float(_nelems(avals[i].shape))
    hbm += sum(_nelems(avals[s].shape) * avals[s].dtype.itemsize for s in out_slots)
    return n_ops, flops, float(hbm)


def _sig(value) -> tuple:
    if isinstance(value, DNDarray):
        s0 = value._DNDarray__shards[0]
        return (tuple(value.gshape), s0.dtype, value.split, value.comm.size, s0.device.type)
    return (tuple(value.shape), value.dtype, value.device.type)


def _float_tensors(outs):
    out = []
    for v in outs:
        for t in _tensors(v) if isinstance(v, DNDarray) else [v]:
            if (t.is_floating_point() or t.is_complex()) and t.numel():
                out.append(t)
    return out


def _finite_flag(ts) -> torch.Tensor:
    """One ``isfinite`` reduction over ``ts``: a 0-d bool on their device."""
    if len(ts) == 1:
        return torch.isfinite(ts[0]).all()
    dev = ts[0].device
    return torch.stack([torch.isfinite(t).all().to(dev) for t in ts]).all()


def _all_finite(values) -> bool:
    """One ``isfinite`` reduction over the float tensors of ``values`` and one
    host read of its flag (True, and no read, when there are none)."""
    ts = _float_tensors(values)
    if not ts:
        return True
    return bool(_finite_flag(ts))


# warn-mode checks whose flags are on their way to the host: (ready, wait,
# flag, trip arguments), oldest first.  The flags land in a ring of pinned
# slots twice as long as the queue can grow, so a slot is drained before
# it is written again.
_DEFER_ON = ("cuda",)
_DEFER_MAX = 64
_DEFERRED: "deque" = deque()
_HOST_FLAGS = []  # [pinned ring, next slot]
# the queue and the ring are shared by every thread that materializes
_DEFER_LOCK = threading.Lock()


def _defer_flag(flag: torch.Tensor):
    """``flag`` copied to the host without waiting: (host flag, ready,
    wait)."""
    if flag.device.type != "cuda":
        return flag, (lambda: True), (lambda: None)
    with _DEFER_LOCK:
        if not _HOST_FLAGS:
            _HOST_FLAGS.extend([torch.empty(2 * _DEFER_MAX + 2, dtype=torch.bool, pin_memory=True), 0])
        ring, i = _HOST_FLAGS
        _HOST_FLAGS[1] = (i + 1) % ring.numel()
    host = ring[i]
    host.copy_(flag, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev.query, ev.synchronize


def drain_guard(wait: bool = False) -> None:
    """Read the flags of deferred guard checks, oldest first: those whose
    copy has landed, or with ``wait`` all of them (free after a host read,
    which has waited for the card already).  A flag that says non-finite
    runs the check's replay and warning."""
    while True:
        with _DEFER_LOCK:
            if not _DEFERRED:
                return
            ready, block, host, ctx = _DEFERRED[0]
            if not wait and len(_DEFERRED) <= _DEFER_MAX and not ready():
                return
            _DEFERRED.popleft()
        block()
        if not bool(host):
            _guard_trip(*ctx)


def _reaches(instrs, root_slot, target_slot) -> bool:
    memo: "dict[int, bool]" = {}

    def walk(s):
        if s == target_slot:
            return True
        got = memo.get(s)
        if got is not None:
            return got
        ins = instrs[s]
        memo[s] = r = ins[0] == "O" and any(walk(c) for c in ins[3])
        return r

    found = walk(root_slot)
    walk = None  # noqa: F841  (unbind the recursive closure's cycle)
    return found


def _guard_check(outs, instrs, sites, leaves, out_slots) -> None:
    """Raise or warn when the program *introduced* NaN/Inf (heat_tpu
    :784): one joint ``isfinite`` reduction over the float outputs and one
    host read, deferred in ``warn`` mode on the card (:func:`drain_guard`)."""
    ts = _float_tensors(outs)
    if not ts:
        return
    flag = _finite_flag(ts)
    strict = guard.strict()
    ctx = (instrs, sites, leaves, out_slots, strict)
    if strict or flag.device.type not in _DEFER_ON:
        if not bool(flag):
            _guard_trip(*ctx)
        return
    host, ready, block = _defer_flag(flag)
    with _DEFER_LOCK:
        _DEFERRED.append((ready, block, host, ctx))
    if len(_DEFERRED) > _DEFER_MAX:
        drain_guard()


def _guard_trip(instrs, sites, leaves, out_slots, strict: bool) -> None:
    """The flag said non-finite.  If a leaf already held non-finite values
    the chain merely propagated them and nothing happens; else the
    deduplicated list is replayed op by op, once, to name the first op
    whose finite inputs went non-finite and every root it feeds.  Raises
    when the check was made in ``raise`` mode (``strict``), else warns."""
    vals = [lf.value for lf in leaves]
    if not _all_finite(vals):
        return  # propagation, not production
    count_fallback("guard_replay")
    leaf_avals = [lf.aval for lf in leaves]
    err = None
    env = []
    with _eager():
        for i, ins in enumerate(instrs):
            if ins[0] == "L":
                env.append(vals[ins[1]])
                continue
            _, fn, kw, ch = ins
            val = fn(*[env[c] for c in ch], **dict(kw))
            env.append(val)
            if not _all_finite([val]):
                name = op_name(fn, kw)
                site = sites[i]
                subtree = _render_instrs(instrs, leaf_avals, out_slots, upto=i, mark=i)
                consumers = ""
                if len(out_slots) > 1:
                    fed = [k for k, s in enumerate(out_slots) if _reaches(instrs, s, i)]
                    consumers = (
                        f"; feeds output(s) {', '.join('%%%d' % out_slots[k] for k in fed)}"
                        f" (root index {', '.join(str(k) for k in fed)})"
                        f" of the {len(out_slots)}-output program"
                    )
                err = NonFiniteError(
                    f"non-finite values first produced by op '{name}' "
                    f"(built at {guard.format_site(site)}){consumers}; "
                    f"offending subtree:\n{subtree}",
                    op=name, site=site, subtree=subtree,
                )
                break
    if err is None:
        # the replay stayed finite: the non-finites exist only in the
        # program's delivered output (an injected corruption)
        subtree = _render_instrs(instrs, leaf_avals, out_slots)
        err = NonFiniteError(
            "non-finite values in the program's output, but an op-by-op replay "
            "of the same chain is finite (rerun with HEAT_TPU_FUSE=off to confirm); "
            f"chain:\n{subtree}",
            op=None, site=None, subtree=subtree,
        )
    eid = telemetry.record_event(
        "guard_blame", op=err.op, site=guard.format_site(err.site) if err.site else None,
        n_roots=len(out_slots), strict=strict,
    )
    err.event_id = eid
    if strict:
        telemetry.postmortem("guard_raise")
        raise err
    w = guard.NonFiniteWarning(str(err))
    w.event_id = eid
    warnings.warn(w, skip_file_prefixes=(guard._PKG_ROOT,))  # the user line


def _run_many(exprs):
    """Run several roots as one program inside a ``fusion.materialize``
    span; returns one concrete value per root."""
    with telemetry.span("fusion.materialize", roots=len(exprs)):
        return _run_many_impl(exprs)


def _run_many_impl(exprs):
    if _DEFERRED:
        drain_guard()
    instrs, sites, leaves, out_slots, avals = _walk(*exprs)
    _check_unwritten(leaves)
    vals = [lf.value for lf in leaves]
    if sanitize.enabled():
        for v in vals:
            sanitize.check_use(_tensors(v), "fusion.materialize")
    guard_on = guard.enabled()
    key = (instrs, out_slots, tuple(_sig(v) for v in vals), guard_on, _terminator_salt(), _cache_salt())
    device = _tensors(vals[0])[0].device if vals else None
    entry = _CACHE.get(key)
    if entry is None:
        _STATS["misses"] += 1
        n_roots = len(out_slots)
        _ROOTS_PER_PROGRAM[n_roots] = _ROOTS_PER_PROGRAM.get(n_roots, 0) + 1
        fp = None
        ops, flops, hbm = 0, 0.0, 0.0
        if telemetry.ledger_enabled():
            fp = _program_fingerprint(instrs, out_slots)
            ops, flops, hbm = _estimate_cost(instrs, avals, out_slots)
        mesh_info = {"devices": _mesh_size(leaves)}
        telemetry.record_event("cache_miss", fingerprint=fp, n_roots=n_roots)
        telemetry.record_event("compile_begin", fingerprint=fp, n_roots=n_roots, ops=ops,
                               mesh=mesh_info, flops=flops, hbm_bytes=hbm)
        t0 = time.monotonic()
        guard.fire("fusion.compile")
        custom = None
        if n_roots == 1 and _TERMINATORS:
            # schedule-controlled engines (the overlap ring) take single
            # roots; multi-root programs are always the generic list
            custom = _lower_terminated(instrs, leaves, avals, out_slots[0], guard_on)
        entry = _Program(instrs, out_slots, tuple(lf.aval for lf in leaves), custom)
        entry.fp = fp
        if program_audit.enabled():
            fp_a = fp if fp is not None else _program_fingerprint(instrs, out_slots)
            outs = program_audit.audited("fused", fp_a, entry.run, (vals,), expect="reduce")
        else:
            outs = entry.run(vals)
        telemetry.record_event("compile_end", fingerprint=fp, ok=True, dur_s=round(time.monotonic() - t0, 6),
                               n_roots=n_roots, ops=ops, flops=flops, hbm_bytes=hbm, mesh=mesh_info)
        if fp is not None:
            telemetry.record_program(fp, kind="fused", n_roots=n_roots, ops=ops, flops=flops, hbm_bytes=hbm,
                                     mesh=mesh_info)
        _CACHE[key] = entry
        while len(_CACHE) > _CACHE_MAX:
            _, evicted = _CACHE.popitem(last=False)
            _STATS["evictions"] += 1
            telemetry.record_event("cache_evict", fingerprint=evicted.fp)
    else:
        _STATS["hits"] += 1
        entry.hits += 1
        _CACHE.move_to_end(key)
        telemetry.program_hit(entry.fp)
        telemetry.record_event("cache_hit", fingerprint=entry.fp)
        guard.fire("fusion.exec")
        outs = telemetry.timed_call(entry.fp, entry.run, vals, device=device)
    outs = tuple(guard.corrupt("fusion.exec", tuple(outs)))
    if guard_on:
        _guard_check(outs, instrs, sites, leaves, out_slots)
    return outs


def _mesh_size(leaves) -> int:
    for lf in leaves:
        if isinstance(lf.value, DNDarray):
            return lf.value.comm.size
    return 1


# ----------------------------------------------------------- lazy DNDarray

class LazyDNDarray(DNDarray):
    """A DNDarray whose shards are a pending :class:`Expr`.

    Shape, dtype, split, device and comm are exact at once; every code path
    that reads the shard slot (``.larray``, ``.shards``, ``numpy()``,
    ``__bool__``, ``resplit_``, printing, ...) reaches ``__getattr__`` on
    the missing slot, which runs the DAG through the program cache and
    keeps the result."""

    def __init__(self, expr, gshape, dtype, split, device, comm, tdev):
        d = self.__dict__
        d["_DNDarray__gshape"] = tuple(int(s) for s in gshape)
        d["_DNDarray__dtype"] = dtype
        d["_DNDarray__split"] = split
        d["_DNDarray__device"] = device
        d["_DNDarray__comm"] = comm
        d["_DNDarray__halos"] = None
        d["_expr"] = expr
        d["_tdev"] = tdev

    def __getattr__(self, name):
        if name == "_DNDarray__shards":
            expr = self._expr
            value = _settle(_run_many((expr,))[0], self)
            _adopt_value(self, expr, value)
            return self.__dict__["_DNDarray__shards"]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        # still pending + copy=True: the cast joins the DAG
        if copy and enabled() and _pending(self):
            from . import types

            ht_dtype = types.canonical_heat_type(dtype)
            try:
                casted = cast_node(self._expr, ht_dtype, (self.device, self.comm))
            except Unfusable:
                return super().astype(dtype, copy)
            return LazyDNDarray(casted, self.gshape, ht_dtype, self.split, self.device, self.comm, self._tdev)
        return super().astype(dtype, copy)


def _settle(value, x):
    """The program's value for the root ``x``: a concrete DNDarray in the
    split ``x`` was promised."""
    if not isinstance(value, DNDarray):
        from .dndarray import _wrap

        value = _wrap(value, x.split, x.device, x.comm)
    if value.split != x.split:
        value = value._resplit(x.split, exact=True)
    return value


def _adopt_value(x, expr, value) -> None:
    """Leafify ``expr`` with ``value`` (pinned for the node's remaining
    life: later chains read it as a leaf) and make ``x`` concrete."""
    shards = value._DNDarray__shards
    expr.leafify(DNDarray._unledgered(shards, x.gshape, x.dtype, x.split, x.device, x.comm), x.gshape)
    _pin(expr, expr.value)
    memtrack.tag_shards(shards, "output")
    x.__dict__["_DNDarray__shards"] = list(shards)
    x.__dict__["_expr"] = None


def defer(expr: Expr, gshape, dtype, split, device, comm, tdev) -> LazyDNDarray:
    """Wrap a DAG root as a lazy DNDarray with the given metadata; ``tdev``
    is the torch device its shards will live on."""
    return LazyDNDarray(expr, tuple(gshape), dtype, split, device, comm, tdev)


def materialize_all(*arrays):
    """Materialize several (possibly lazy) DNDarrays as ONE program: subtrees
    shared between the roots run once.  Concrete arrays pass through;
    roots on meshes of different sizes run as one program per mesh.
    Returns ``arrays`` as a tuple, every element concrete."""
    pending, seen = [], set()
    for x in arrays:
        if _pending(x) and id(x) not in seen:
            seen.add(id(x))
            pending.append(x)
    while pending:
        head = pending[0]
        group = [x for x in pending if x.comm is head.comm or x.comm.size == head.comm.size]
        gids = {id(x) for x in group}
        pending = [x for x in pending if id(x) not in gids]
        if len(group) == 1:
            group[0].shards  # the ordinary __getattr__ path
            continue
        outs = _run_many(tuple(x._expr for x in group))
        for x, value in zip(group, outs):
            _adopt_value(x, x._expr, _settle(value, x))
    for x in arrays:
        x.shards
    return tuple(arrays)


def materialize(*arrays):
    """Force one or more (possibly lazy) DNDarrays to concrete shards.
    ``materialize(x)`` returns ``x``; ``materialize(a, b, ...)`` runs every
    pending root as one program (see :func:`materialize_all`) and returns
    the arrays as a tuple.  Exported as ``heat_tpu_torch.materialize``."""
    if not arrays:
        raise TypeError("materialize() requires at least one array")
    if len(arrays) == 1:
        arrays[0].shards
        return arrays[0]
    return materialize_all(*arrays)


# --------------------------------------------------------- chain terminators
# Schedule-controlled engines (parallel/overlap.py's ring matmul) register a
# lowerer consulted at a cache miss of a single-root program, before the
# generic instruction list is kept.  Contract: lowerer(instrs, leaves,
# out_slot, gshape, split, comm, with_guard) -> program(vals) -> the root's
# value, or None to decline.  The program enters the same cache entry, so
# cache_stats() counts terminated chains as any other.  ``salt`` adds the
# engine's dispatch state (mode, threshold) to the cache key.  A lowerer
# that raises, raises (heat_tpu swallows it; the port has no eager rescue).

_TERMINATORS: "list[Tuple[Callable, Optional[Callable]]]" = []


def register_terminator(lowerer: Callable, salt: Optional[Callable] = None) -> Callable:
    """Register a chain lowerer (see the block comment above)."""
    _TERMINATORS.append((lowerer, salt))
    return lowerer


def _terminator_salt() -> tuple:
    return tuple(s() for _, s in _TERMINATORS if s is not None)


# zero-argument callables whose results join every cache key (the tuning
# plane's generation: a winner that flips builds a distinct program)
_CACHE_SALTS: "list[Callable]" = []


def register_cache_salt(fn: Callable) -> Callable:
    """Register a zero-argument callable whose result joins every program
    cache key (once per callable)."""
    if fn not in _CACHE_SALTS:
        _CACHE_SALTS.append(fn)
    return fn


def _cache_salt() -> tuple:
    return tuple(s() for s in _CACHE_SALTS)


def _lower_terminated(instrs, leaves, avals, out_slot, with_guard):
    root = avals[out_slot]
    comm = next((lf.value.comm for lf in leaves if isinstance(lf.value, DNDarray)), None)
    if not root.array or comm is None:
        return None
    for lowerer, _ in _TERMINATORS:
        program = lowerer(instrs, leaves, out_slot, tuple(root.shape), root.split, comm, with_guard)
        if program is not None:
            return program
    return None


# ------------------------------------------- split-boundary terminators
# Lowerers consulted when a pending chain ends at a split change.  Contract:
# lowerer(instrs, leaves, avals, out_slot, gshape, old_split, new_split,
# comm, tile_bytes) -> the shards in the NEW split, or None to decline.
# parallel/transport.py registers its own on first use.

_SPLIT_TERMINATORS: "list[Callable]" = []


def register_split_terminator(lowerer: Callable) -> Callable:
    """Register a split-boundary lowerer (see ``_SPLIT_TERMINATORS``)."""
    _SPLIT_TERMINATORS.append(lowerer)
    return lowerer


def materialize_resplit(x, new_split, tile_bytes=None):
    """Evaluate a pending chain straight into the new split's transport
    loop: the shards of ``x`` in ``new_split``, or None when the chain is
    not pending, the boundary is no split change, or every lowerer
    declines (the caller then materializes and resplits).  ``x`` itself
    stays pending: its other consumers still need the old-split value."""
    if not enabled() or not _pending(x):
        return None
    if new_split is None or x.split is None or new_split == x.split:
        return None
    from ..parallel import transport

    transport.ensure_fused_tail_registered()
    expr = x._expr
    if expr is None:
        return None
    instrs, sites, leaves, out_slots, avals = _walk(expr)
    _check_unwritten(leaves)
    for lowerer in _SPLIT_TERMINATORS:
        out = lowerer(instrs, leaves, avals, out_slots[0], tuple(x.gshape), x.split, int(new_split), x.comm,
                      tile_bytes)
        if out is not None:
            if guard.enabled():
                snap = DNDarray._unledgered(out, x.gshape, x.dtype, int(new_split), x.device, x.comm)
                _guard_check((snap,), instrs, sites, leaves, out_slots)
            return out
    return None
