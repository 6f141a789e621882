"""Out-of-core streaming: chunk sources and double-buffered host-to-card
slabs under a residency budget (counterpart of heat_tpu/core/stream.py).

**Chunk sources.**  :func:`read_rows` is the one copy of the slab
arithmetic: rows ``[lo, hi)`` of the split axis, every other axis whole,
honouring the step of a user's ``slices`` (``base``).  Every HDF5, NetCDF,
``.npy`` and in-memory slab read goes through it and, below it, through
``io._read_region``, the funnel the tests spy on.  :func:`open_source`
wraps a path or an array-like behind one small handle (``shape``,
``np_dtype``, ``read(lo, hi)``, ``close``).

**Residency plan.**  :func:`plan_pass` resolves the budget (an argument >
``HEAT_TPU_STREAM_BUDGET`` > the measured headroom,
``memtrack.suggest_budget``, ledgered through ``autotune.note_budget_seed``
> :data:`DEFAULT_BUDGET`), sizes a slab at most ``budget // 3`` (three
slabs are live at once: the one computed on, the prefetched one and the
consumer's loop reference), rounded down to the mesh size, and the host
prefetch depth; the slab fraction is the tuner's ``STREAM_ARMS`` arm, every
arm numerically identical.

**The pass.**  :class:`StreamPass` runs a daemon reader thread (host reads
into a bounded queue, a ``None`` poison pill at the end or on failure, the
error handed to the consumer).  On the card the reader copies each slab
into a pinned host buffer the pass owns; the consumer copies it to the card
with ``non_blocking=True`` and records an event, and a buffer is refilled
only after its event has completed, so slab k+1's read and transfer overlap
slab k's compute.  The next slab is fetched before the current one is
yielded; slabs have a fixed row count (the tail zero-padded).  An
out-of-memory error (``torch.OutOfMemoryError``) while a slab is placed
halves the slab (at least one row a position) and re-cuts the rows in hand
(``stream_oom_retry``).  ``overlap_frac`` is ``1 - stall/io``: *stall* is
the consumer's time blocked on the queue after the first fetch (the cold
fill, ``fill_s``), *io* the reader's time reading and staging.  The
``staging`` tag's high-water mark (``memtrack.summary()
["peak_bytes_by_tag"]``) is the budget's proof.  ``stream_slab`` and
``stream_pass`` events go to the flight recorder.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import autotune, guard, memtrack, telemetry

__all__ = [
    "ChunkSource",
    "DEFAULT_BUDGET",
    "Slab",
    "StreamPass",
    "StreamPlan",
    "finish_pass",
    "open_source",
    "plan_pass",
    "read_rows",
    "residency_budget",
    "stats",
]

# residency when nothing is measured and nothing set: two 128 MiB slabs
DEFAULT_BUDGET = 256 << 20

_STATS = telemetry.register_group(
    "stream",
    {
        "sources": 0,  # chunk sources opened
        "passes": 0,  # completed streaming passes
        "slabs": 0,  # device slabs produced
        "bytes_read": 0,  # host bytes read off disk or memory
        "oom_retries": 0,  # slab transfers retried after OOM
        "slab_shrinks": 0,  # slab-row halvings (OOM back-off)
        "io_s": 0.0,  # reader-thread seconds reading and staging
        "stall_s": 0.0,  # consumer seconds blocked on the queue
        "fill_s": 0.0,  # the first fetch's pipeline fill
    },
)


def stats() -> dict:
    """Snapshot of the ``stream`` counter group (``heat_tpu_stream_*`` in
    the Prometheus export)."""
    return telemetry.snapshot_group("stream")


def read_rows(source, lo: int, hi: int, *, split_axis: int = 0, base: Optional[tuple] = None, copy: bool = False) -> np.ndarray:
    """Rows ``[lo, hi)`` of ``split_axis``, full extent elsewhere, as a host
    ndarray.  With ``base`` (one normalised slice per axis, as
    ``io._normalize_slices`` gives them) ``lo`` and ``hi`` count rows of
    ``base[split_axis]``, its step included.  ``copy=True`` forces a copy
    (views into a file's memory map must not outlive the file); a memory
    map read is always copied."""
    from . import io as ht_io  # io imports this module

    if base is None:
        sel = tuple(slice(lo, hi) if d == split_axis else slice(0, n) for d, n in enumerate(source.shape))
    else:
        bs = base[split_axis]
        step = 1 if bs.step is None else bs.step
        start = 0 if bs.start is None else bs.start
        sel = list(base)
        sel[split_axis] = slice(start + lo * step, start + hi * step, step)
        sel = tuple(sel)
    out = ht_io._read_region(source, sel)
    if copy or isinstance(source, np.memmap) or isinstance(out, np.memmap):
        out = np.array(out)
    return np.asarray(out)


class ChunkSource:
    """A row-sliceable host source: ``shape``, ``np_dtype``,
    ``read(lo, hi)`` gives rows ``[lo, hi)`` as a host ndarray, ``close()``
    (idempotent).  A context manager."""

    shape: Tuple[int, ...] = ()
    np_dtype: np.dtype = np.dtype(np.float32)

    def read(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "ChunkSource":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _cast(self, arr: np.ndarray) -> np.ndarray:
        return arr if arr.dtype == self.np_dtype else arr.astype(self.np_dtype)


class _ArraySource(ChunkSource):
    """An ndarray, a live h5py dataset, a memory map: anything with a
    ``shape`` and basic slicing."""

    def __init__(self, obj, np_dtype=None):
        self._obj = obj
        self.shape = tuple(obj.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else getattr(obj, "dtype", np.float32))

    def read(self, lo: int, hi: int) -> np.ndarray:
        return self._cast(read_rows(self._obj, lo, hi))


class _H5Source(ChunkSource):
    def __init__(self, path: str, dataset: str, np_dtype=None):
        import h5py

        self._handle = h5py.File(path, "r")
        try:
            self._dset = self._handle[dataset]
        except KeyError:
            self._handle.close()
            raise
        self.shape = tuple(self._dset.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else self._dset.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        return self._cast(read_rows(self._dset, lo, hi))

    def close(self) -> None:
        if self._handle is not None:
            self._handle.close()
            self._handle = None


class _NetCDFSource(ChunkSource):
    def __init__(self, path: str, variable: str, np_dtype=None):
        from . import io as ht_io

        self._handle = ht_io._netcdf_open(path)
        self._var = self._handle.variables[variable]
        self.shape = tuple(self._var.shape)
        self.np_dtype = np.dtype(np_dtype if np_dtype is not None else self._var.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        # scipy's classic-format reads are views into the file's memory map
        return self._cast(read_rows(self._var, lo, hi, copy=True))

    def close(self) -> None:
        if self._handle is None:
            return
        self._var = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self._handle.close()
        self._handle = None


def open_source(source, dataset: Optional[str] = None, *, np_dtype=None) -> ChunkSource:
    """A streamable row source: a path (``.h5``/``.hdf5`` and
    ``.nc``/``.nc4``/``.netcdf`` with ``dataset`` named, ``.npy`` memory
    mapped), an array-like with ``shape`` and ``__getitem__``, or an open
    :class:`ChunkSource`, returned as it is (its caller keeps it)."""
    if isinstance(source, ChunkSource):
        return source
    _STATS["sources"] += 1
    if isinstance(source, str):
        ext = os.path.splitext(source)[-1].lower().strip()
        if ext in (".h5", ".hdf5"):
            if dataset is None:
                raise ValueError("HDF5 sources need a dataset name")
            return _H5Source(source, dataset, np_dtype)
        if ext in (".nc", ".nc4", ".netcdf"):
            if dataset is None:
                raise ValueError("NetCDF sources need a variable name")
            return _NetCDFSource(source, dataset, np_dtype)
        if ext == ".npy":
            return _ArraySource(np.load(source, mmap_mode="r"), np_dtype)
        raise ValueError(f"unsupported streaming source extension {ext!r}")
    if hasattr(source, "shape") and hasattr(source, "__getitem__"):
        return _ArraySource(source, np_dtype)
    raise TypeError(f"cannot stream from {type(source)}")


# -------------------------------------------------------------- the budget


def residency_budget(budget: Optional[int] = None) -> int:
    """The streaming residency budget in bytes: ``budget`` >
    ``HEAT_TPU_STREAM_BUDGET`` > half the measured free device memory
    (``memtrack.suggest_budget``; a grant below the default is ledgered by
    ``autotune.note_budget_seed``) > :data:`DEFAULT_BUDGET` where no device
    reports."""
    if budget is not None:
        return int(budget)
    if os.environ.get("HEAT_TPU_STREAM_BUDGET", "").strip():
        return autotune.env_bytes("HEAT_TPU_STREAM_BUDGET", DEFAULT_BUDGET)
    granted = memtrack.suggest_budget(DEFAULT_BUDGET, fraction=0.5)
    if granted is None or granted <= 0:
        return DEFAULT_BUDGET
    if granted < DEFAULT_BUDGET:
        autotune.note_budget_seed("stream.slab", granted, DEFAULT_BUDGET)
    return granted


class StreamPlan(NamedTuple):
    site: str  # consumer site ("kmeans_fit", ...)
    rows: int  # logical rows of the source
    row_bytes: int  # bytes of one row at the streaming dtype
    slab_rows: int  # device slab rows (a multiple of the mesh size)
    depth: int  # host prefetch queue capacity, in slabs
    budget: int  # resolved residency budget, bytes
    arm: str  # the STREAM_ARMS member that sized slab_rows
    key: Optional[Tuple[str, str]]  # tuning-table key (None: tuner off)


_ARM_DIV = {"slab_full": 1, "slab_half": 2, "slab_quarter": 4}


def _round_down(x: int, m: int) -> int:
    return (x // m) * m


def _pick_arm(key: Tuple[str, str]) -> str:
    """The least-sampled arm while exploring: every arm gives the same
    values, so each pass runs one arm and rotation fills them all."""
    e = autotune.table().get(key)
    counts = {a: len(e["arms"].get(a, [])) if e else 0 for a in autotune.STREAM_ARMS}
    return min(autotune.STREAM_ARMS, key=lambda a: counts[a])


def plan_pass(src: ChunkSource, *, comm=None, site: str = "stream", budget: Optional[int] = None) -> StreamPlan:
    """Size one pass over ``src``: the budget, the tuner's slab fraction,
    slab rows (at most ``budget // 3`` bytes, a multiple of the mesh size)
    and the host prefetch depth (the rest of the budget, in [1, 4])."""
    from ..parallel.mesh import sanitize_comm

    comm = sanitize_comm(comm)
    shape = src.shape
    if not shape:
        raise ValueError("streaming sources must have at least one dim")
    rows = int(shape[0])
    row_bytes = int(src.np_dtype.itemsize)
    for n in shape[1:]:
        row_bytes *= int(n)
    b = residency_budget(budget)
    n_dev = comm.size
    max_rows = max(n_dev, _round_down((b // 3) // max(row_bytes, 1), n_dev))
    arm, key = "slab_full", None
    if autotune.enabled():
        key = autotune.stream_key(site, rows.bit_length(), shape[1:], str(src.np_dtype), n_dev, int(b).bit_length())
        d = autotune.decide(key, _pick_arm(key), desc=f"stream {site} {shape}", arms=autotune.STREAM_ARMS)
        arm = d.arm
    slab_rows = max(n_dev, _round_down(max_rows // _ARM_DIV[arm], n_dev))
    depth = max(1, min(4, b // max(slab_rows * row_bytes, 1) - 1))
    return StreamPlan(site, rows, row_bytes, slab_rows, depth, b, arm, key)


# ---------------------------------------------------------------- the pass


class Slab(NamedTuple):
    index: int  # 0-based slab number within the pass
    x: Any  # DNDarray (slab_rows, *features), split=0
    valid: int  # rows [0, valid) are real; the rest are zero padding
    base: int  # global row offset of this slab's row 0


class _Staging:
    """The pass's pinned host buffers on the card: the reader fills a free
    one, the consumer's copies to the card read it, and it is free again
    once the event recorded after its last copy has completed."""

    def __init__(self, n: int, rows: int, tail: tuple, dtype: torch.dtype):
        self._free: "queue_mod.Queue" = queue_mod.Queue()
        for _ in range(n):
            self._free.put((torch.empty((rows,) + tail, dtype=dtype, pin_memory=True), None))

    def take(self, halt: threading.Event):
        while not halt.is_set():
            try:
                buf, ev = self._free.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            if ev is not None:
                ev.synchronize()
            return buf
        return None

    def give(self, buf: torch.Tensor, stream) -> None:
        ev = torch.cuda.Event()
        ev.record(stream)
        self._free.put((buf, ev))


class _Reader(threading.Thread):
    """Daemon host-read loop: slabs into a bounded queue, a ``None`` poison
    pill at the end or on failure, the error kept in ``self.error`` for the
    consumer.  With staging, each slab is copied into a pinned buffer."""

    def __init__(self, src: ChunkSource, q: "queue_mod.Queue", slab_rows: int, rows: int, stop: threading.Event,
                 staging: Optional[_Staging]):
        super().__init__(daemon=True, name="heat-tpu-stream-reader")
        self._src = src
        self._q = q
        self._slab_rows = slab_rows
        self._rows = rows
        self._halt = stop  # not _stop: threading.Thread has a _stop method
        self._staging = staging
        self.error: Optional[BaseException] = None
        self.io_s = 0.0
        self.bytes_read = 0

    def _put(self, item) -> None:
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue_mod.Full:
                continue

    def run(self) -> None:
        try:
            lo = 0
            while lo < self._rows and not self._halt.is_set():
                hi = min(lo + self._slab_rows, self._rows)
                t0 = time.perf_counter()
                host = self._src.read(lo, hi)
                self.bytes_read += host.nbytes
                if self._staging is not None:
                    buf = self._staging.take(self._halt)
                    if buf is None:
                        break
                    rows_t = buf[: hi - lo]
                    rows_t.numpy()[...] = host
                else:
                    buf, rows_t = None, torch.from_numpy(np.ascontiguousarray(host))
                self.io_s += time.perf_counter() - t0
                self._put((lo, rows_t, buf))
                lo = hi
        except BaseException as e:
            self.error = e
        finally:
            self._put(None)


class StreamPass:
    """One single-use streaming pass: iterate to get :class:`Slab` s.

    The iterator prefetches: slab k+1 is dequeued and its copy to the card
    issued before slab k is yielded.  The slab shape is fixed for the pass
    (tail zero-padded) until an out-of-memory error halves it.  Use as an
    iterator or a context manager; ``close()`` (idempotent, also at the
    end of iteration) stops and joins the reader."""

    def __init__(self, src: ChunkSource, *, comm=None, plan: Optional[StreamPlan] = None, site: str = "stream",
                 budget: Optional[int] = None):
        from . import devices
        from ..parallel.mesh import sanitize_comm

        self._src = open_source(src)
        self.comm = sanitize_comm(comm)
        self.device = devices.sanitize_device(None)  # slabs land on the default device, as heat_tpu's
        self._tdev = self.device.torch_device
        self.plan = plan if plan is not None else plan_pass(self._src, comm=self.comm, site=site, budget=budget)
        self.slab_rows = self.plan.slab_rows
        self.stall_s = 0.0
        self.fill_s = 0.0
        self.slabs = 0
        self.oom_retries = 0
        self._item = None
        self._off = 0
        self._got_first = False
        self._t0 = time.perf_counter()
        self._t1: Optional[float] = None
        self._stop = threading.Event()
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.plan.depth)
        self._staging = None
        if self._tdev.type == "cuda":
            tail = tuple(int(d) for d in self._src.shape[1:])
            dt = torch.from_numpy(np.zeros(0, self._src.np_dtype)).dtype
            self._staging = _Staging(self.plan.depth + 2, self.plan.slab_rows, tail, dt)
        self._reader = _Reader(self._src, self._q, self.plan.slab_rows, self.plan.rows, self._stop, self._staging)
        self._reader.start()

    # -- lifecycle

    def close(self) -> None:
        """Stop and join the reader (stop event + drain); safe to call
        again and from ``__del__``."""
        if self._t1 is None:
            self._t1 = time.perf_counter()
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._reader.join(timeout=5.0)
        _STATS["io_s"] += self._reader.io_s
        _STATS["stall_s"] += self.stall_s
        _STATS["fill_s"] += self.fill_s
        _STATS["bytes_read"] += self._reader.bytes_read

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "StreamPass":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- measured report

    @property
    def wall_s(self) -> float:
        end = self._t1 if self._t1 is not None else time.perf_counter()
        return end - self._t0

    def overlap_frac(self) -> float:
        """The share of the reader's time hidden behind the consumer's work:
        ``1 - stall/io``, the cold first fetch excluded (``fill_s``)."""
        io = self._reader.io_s
        if io <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.stall_s / io)

    def report(self) -> dict:
        return {
            "slabs": self.slabs,
            "slab_rows": self.slab_rows,
            "bytes_read": self._reader.bytes_read,
            "io_s": round(self._reader.io_s, 6),
            "stall_s": round(self.stall_s, 6),
            "fill_s": round(self.fill_s, 6),
            "wall_s": round(self.wall_s, 6),
            "overlap_frac": round(self.overlap_frac(), 4),
            "oom_retries": self.oom_retries,
        }

    # -- slab production

    def _place(self, rows_t: torch.Tensor, take: int):
        """One slab on its device: ``rows_t``'s rows, zeros to ``slab_rows``,
        split over the mesh and tagged ``staging``."""
        from .dndarray import _wrap

        guard.fire("stream.slab")
        dev = torch.empty((self.slab_rows,) + tuple(rows_t.shape[1:]), dtype=rows_t.dtype, device=self._tdev)
        dev[:take].copy_(rows_t, non_blocking=True)
        if take < self.slab_rows:
            dev[take:].zero_()
        x = _wrap(dev, 0, self.device, self.comm)
        memtrack.tag_shards(x.shards, "staging")
        return x

    def _shrink(self, exc: BaseException) -> None:
        n_dev = self.comm.size
        if self.slab_rows <= n_dev:
            raise exc
        new = max(n_dev, _round_down(self.slab_rows // 2, n_dev))
        _STATS["oom_retries"] += 1
        _STATS["slab_shrinks"] += 1
        self.oom_retries += 1
        telemetry.record_event("stream_oom_retry", site=self.plan.site, slab_rows=self.slab_rows, retry_rows=new,
                               error=str(exc)[:160])
        self.slab_rows = new

    def _release(self) -> None:
        """The item in hand is used up: its pinned buffer may be refilled
        once the copies issued from it have run."""
        if self._item is not None and self._item[2] is not None:
            self._staging.give(self._item[2], torch.cuda.current_stream(self._tdev))
        self._item = None

    def _fetch(self) -> Optional[Slab]:
        while True:
            if self._item is None or self._off >= self._item[1].shape[0]:
                self._release()
                t0 = time.perf_counter()
                item = self._q.get()
                dt = time.perf_counter() - t0
                if self._got_first:
                    self.stall_s += dt
                else:
                    self._got_first = True
                    self.fill_s += dt
                if item is None:
                    if self._reader.error is not None:
                        raise RuntimeError(f"stream reader failed for {self.plan.site!r}") from self._reader.error
                    return None
                self._item = item
                self._off = 0
            lo, rows_all, _ = self._item
            take = min(self.slab_rows, rows_all.shape[0] - self._off)
            base = lo + self._off
            try:
                x = self._place(rows_all[self._off : self._off + take], take)
            except Exception as e:
                if not _is_oom(e):
                    raise
                # halve and re-cut this slab's rows: _off is unchanged
                self._shrink(e)
                continue
            self._off += take
            slab = Slab(self.slabs, x, take, base)
            self.slabs += 1
            _STATS["slabs"] += 1
            telemetry.record_event("stream_slab", site=self.plan.site, index=slab.index, rows=self.slab_rows,
                                   valid=take, base=base, arm=self.plan.arm)
            return slab

    def __iter__(self):
        try:
            nxt = self._fetch()
            while nxt is not None:
                cur = nxt
                # prefetch before yielding: slab k+1's copy is issued while
                # the caller computes on slab k
                nxt = self._fetch()
                yield cur
        finally:
            self._release()
            self.close()


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.OutOfMemoryError)


def finish_pass(sp: StreamPass) -> dict:
    """Close a completed pass: its wall goes to the tuner as the arm's
    sample, the pass is counted and flight-recorded, and the report is
    returned (its consumer puts ``overlap_frac``/``io_bytes`` on its
    program row)."""
    sp.close()
    rep = sp.report()
    _STATS["passes"] += 1
    pl = sp.plan
    if pl.key is not None and autotune.enabled():
        autotune.observe(pl.key, pl.arm, sp.wall_s)
    telemetry.record_event("stream_pass", site=pl.site, arm=pl.arm, budget=pl.budget, **rep)
    return rep
