"""Endpoint registry and step cache: the serving engine (counterpart of
heat_tpu/serving/engine.py).

A :class:`ServingEngine` turns fitted estimators (``KMeans.predict``,
``Lasso.predict``, ``GaussianNB.predict``, ``KNeighborsClassifier
.predict``) or any ``DNDarray -> DNDarray`` callable (an
``nn.functional.linear`` closure) into concurrently callable endpoints:

* :meth:`register` fixes the endpoint's feature dim, dtype and split and
  derives its **bucket ladder**, power-of-two row counts from
  ``min_bucket`` up through ``max_batch``, so every batch the device sees
  has one of a handful of shapes;
* :meth:`submit` validates and admits a request and hands it to the
  :class:`~heat_tpu_torch.serving.batcher.DynamicBatcher`; the returned
  :class:`~concurrent.futures.Future` resolves to exactly the caller's
  rows (per-request unpadding is a contiguous slice);
* the worker pads each coalesced batch up to the smallest bucket and runs
  it through the **step cache**: one step per (endpoint, bucket),
  fingerprinted into the telemetry program ledger.  A step is a cached
  callable (nothing is compiled): it builds the batch's DNDarray on the
  default device and mesh, runs the endpoint's predict (its kernels, K1
  for the clustering and neighbour models) and reads the result to numpy
  once, which is the batch's one wait for the card.  Identical shapes mean
  the fusion, overlap and tuning caches underneath see no new key after
  warmup.

One worker thread runs an engine's batches.  The kernel wrappers' launch
counters and the fusion engine's program cache are process-wide; the
fusion engine keeps its per-call overrides per thread, so the replicas of
a :class:`~heat_tpu_torch.serving.router.ServingFleet` may run their
steps at once.  An endpoint whose predict raises resolves its batch's
futures with that exception.

Telemetry: the ``serving`` counter group (accepted / rejected / batched /
padded_rows / flush_cause / shed reasons / step compiles), each endpoint's
latency p50/p99 (``heat_tpu_serving_latency_<endpoint>_p50_s`` in
``export_prometheus()``), flight-recorder events for shed / drain / stall,
and one span per batch.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import factories, guard, telemetry
from .admission import AdmissionController, RequestRejected
from .batcher import DynamicBatcher, Request

__all__ = ["Endpoint", "ServingEngine"]

#: per-endpoint latency reservoir depth — enough for a stable p99 under test
#: traffic without unbounded growth
_LATENCY_SAMPLES = 512

_LATENCIES: Dict[str, Deque[float]] = {}


def _quantile(ordered: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample."""
    idx = min(len(ordered) - 1, max(0, int(math.ceil(q * len(ordered))) - 1))
    return ordered[idx]


def _latency_view() -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted(_LATENCIES):
        sample = sorted(_LATENCIES[name])
        if sample:
            out[name] = {
                "count": len(sample),
                "p50_s": round(_quantile(sample, 0.50), 6),
                "p99_s": round(_quantile(sample, 0.99), 6),
            }
    return out


_STATS = telemetry.register_group(
    "serving",
    {
        "accepted": 0,
        "rejected": 0,
        "batched": 0,
        "batches": 0,
        "padded_rows": 0,
        "step_compiles": 0,
        "step_hits": 0,
        "step_errors": 0,
        "swaps": 0,
        "drains": 0,
        "flush_cause": {"max_batch": 0, "timer": 0, "drain": 0},
        "shed": {
            "queue_full": 0,
            "hbm_pressure": 0,
            "stalled": 0,
            "draining": 0,
            "closed": 0,
            "too_large": 0,
            "expired": 0,
        },
        "accepted_by_class": {"high": 0, "normal": 0, "low": 0},
        "shed_by_class": {"high": 0, "normal": 0, "low": 0},
    },
    extra=lambda: {"latency": _latency_view()},
    on_reset=_LATENCIES.clear,
)


def _bump(counter: Dict[str, int], key: str) -> None:
    # class counters grow with operator-configured SLO classes; the
    # three defaults are pre-registered so gauges exist from process start
    counter[key] = counter.get(key, 0) + 1


def _mesh_size() -> int:
    """Positions of the default mesh, on which a step builds its batch."""
    from ..core import communication

    return int(communication.get_comm().size)


def _pow2_buckets(min_bucket: int, max_batch: int) -> Tuple[int, ...]:
    """Power-of-two ladder covering [min_bucket, max_batch] (both
    rounded up to powers of two)."""
    if min_bucket < 1 or max_batch < 1:
        raise ValueError("min_bucket and max_batch must be >= 1")
    size = 1 << (int(min_bucket) - 1).bit_length()
    top = 1 << (int(max_batch) - 1).bit_length()
    ladder = []
    while size < top:
        ladder.append(size)
        size <<= 1
    ladder.append(top)
    return tuple(ladder)


def _dtype_name(dt: Any) -> str:
    # numpy parses its own dtypes; heat's type *classes* parse as
    # dtype('O'), so fall back to the class name ("float32"); a torch
    # dtype prints as "torch.float32"
    try:
        parsed = np.dtype(dt)
        if parsed != np.dtype(object):
            return parsed.name
    except TypeError:
        pass
    return getattr(dt, "__name__", str(dt).replace("torch.", ""))


def _check_swap_compat(endpoint: str, key: str, cur: Any, new: Any) -> None:
    """Refuse operand swaps that would change the step's traced shapes.

    A republished checkpoint is *new operands, not a new program*: a
    shape, dtype or split change would give every bucket step new cache
    keys underneath, so it is rejected here."""
    cur_shape = tuple(getattr(cur, "shape", ()) or ())
    new_shape = tuple(getattr(new, "shape", ()) or ())
    if cur_shape != new_shape:
        raise ValueError(
            f"swap_weights({endpoint!r}): operand {key!r} shape {new_shape} "
            f"!= resident {cur_shape} — a shape change retraces every bucket "
            "step; register a new endpoint instead"
        )
    cur_dt, new_dt = getattr(cur, "dtype", None), getattr(new, "dtype", None)
    if cur_dt is not None and new_dt is not None:
        if _dtype_name(cur_dt) != _dtype_name(new_dt):
            raise ValueError(
                f"swap_weights({endpoint!r}): operand {key!r} dtype "
                f"{_dtype_name(new_dt)} != resident {_dtype_name(cur_dt)} — "
                "a dtype change is a retrace"
            )
    if getattr(cur, "split", None) != getattr(new, "split", None):
        raise ValueError(
            f"swap_weights({endpoint!r}): operand {key!r} split "
            f"{getattr(new, 'split', None)} != resident "
            f"{getattr(cur, 'split', None)} — a resharding is a retrace"
        )


@dataclass(frozen=True)
class Endpoint:
    """One registered predict surface with its frozen shape contract."""

    name: str
    predict: Callable[[Any], Any]
    feature_dim: int
    dtype: "np.dtype"
    split: Optional[int]
    buckets: Tuple[int, ...]
    max_delay_s: float
    model: Any = None

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        for size in self.buckets:
            if rows <= size:
                return size
        raise ValueError(f"{rows} rows exceed largest bucket {self.buckets[-1]}")


class _Step:
    """One cached step: (endpoint, bucket) -> host fn."""

    __slots__ = ("run", "fingerprint", "bucket")

    def __init__(self, run: Callable[[np.ndarray], np.ndarray], fingerprint: str, bucket: int):
        self.run = run
        self.fingerprint = fingerprint
        self.bucket = bucket


class ServingEngine:
    """The front door: endpoint registry, batcher, admission, steps.

    Usable as a context manager (``with ServingEngine() as eng: ...``);
    exit drains queued work then stops the worker."""

    def __init__(
        self,
        *,
        name: str = "",
        admission: Optional[AdmissionController] = None,
        stall_detector=None,
        default_max_delay_s: float = 0.005,
    ):
        # a name marks this engine as one replica of a fleet: its latency
        # reservoirs are keyed "<name>:<endpoint>" so the router can route
        # on *this* replica's percentiles, not a fleet-wide blur
        self.name = str(name)
        self._endpoints: Dict[str, Endpoint] = {}
        self._steps: Dict[Tuple[str, int], _Step] = {}
        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._closed = False
        self.default_max_delay_s = float(default_max_delay_s)
        self.admission = admission if admission is not None else AdmissionController()
        self._batcher = DynamicBatcher(
            self._execute,
            name=f"heat-tpu-torch-serving-batcher-{self.name}"
            if self.name
            else "heat-tpu-torch-serving-batcher",
        )
        self._detector = None
        if stall_detector is not None:
            self.attach_stall_detector(stall_detector)

    # -- registry -------------------------------------------------------

    def attach_stall_detector(self, detector):
        """Wire a :class:`~heat_tpu_torch.utils.fault.StallDetector` into the
        admission gate (push-based shed) and beat it per served batch."""
        self.admission.attach_stall_detector(detector)
        self._detector = detector
        return detector

    def register(
        self,
        name: str,
        model: Any = None,
        *,
        predict: Optional[Callable[[Any], Any]] = None,
        feature_dim: int,
        dtype: Any = np.float32,
        split: Optional[int] = 0,
        min_bucket: Optional[int] = None,
        max_batch: int = 64,
        max_delay_s: Optional[float] = None,
        warm: bool = False,
        quantize: bool = False,
    ) -> Endpoint:
        """Register an endpoint: exactly one of ``model`` (an object with
        ``.predict``) or ``predict`` (a ``DNDarray -> DNDarray`` callable).

        ``min_bucket`` defaults to ``max(8, mesh size)`` so split-0
        batches always give every position at least one row; ``max_batch``
        is rounded up to the bucket ladder's top rung.  ``warm=True`` runs
        every bucket once before the first request lands.

        ``quantize=True`` calls ``model.quantize_()`` before serving —
        the model drops its full-precision resident state for int8
        (e.g. ``KNeighborsClassifier`` quantizes its corpus and serves
        through the quantized ring cdist); requires ``model`` with a
        ``quantize_`` method."""
        if self._closed:
            raise RuntimeError("serving engine is closed")
        if (model is None) == (predict is None):
            raise ValueError("pass exactly one of `model` or `predict`")
        if quantize:
            hook = getattr(model, "quantize_", None)
            if hook is None:
                raise ValueError(
                    "quantize=True needs a `model` exposing quantize_() "
                    f"(got {type(model).__name__})"
                )
            hook()
        if predict is None:
            predict = model.predict
        if name in self._endpoints:
            raise ValueError(f"endpoint {name!r} already registered")
        feature_dim = int(feature_dim)
        if feature_dim < 1:
            raise ValueError(f"feature_dim must be >= 1, got {feature_dim}")
        if min_bucket is None:
            min_bucket = max(8, _mesh_size())
        buckets = _pow2_buckets(min_bucket, max_batch)
        endpoint = Endpoint(
            name=name,
            predict=predict,
            feature_dim=feature_dim,
            dtype=np.dtype(dtype),
            split=split,
            buckets=buckets,
            max_delay_s=self.default_max_delay_s if max_delay_s is None else float(max_delay_s),
            model=model,
        )
        with self._lock:
            self._endpoints[name] = endpoint
        telemetry.record_event(
            "serving_endpoint",
            endpoint=name,
            feature_dim=feature_dim,
            buckets=list(buckets),
            split=split,
            quantized=bool(quantize),
        )
        if warm:
            self.warmup(name)
        return endpoint

    def endpoints(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._endpoints))

    def warmup(self, name: str) -> int:
        """Run every bucket of ``name`` once on zeros so live traffic
        starts on warm caches (kernels built, tables filled).  Returns the
        bucket count."""
        endpoint = self._endpoint(name)
        for bucket in endpoint.buckets:
            step = self._get_step(endpoint, bucket)
            step.run(np.zeros((bucket, endpoint.feature_dim), dtype=endpoint.dtype))
        return len(endpoint.buckets)

    def swap_weights(self, name: str, params: Dict[str, Any]) -> Dict[str, Any]:
        """Hot-swap endpoint ``name``'s model operands under live traffic.

        ``params`` maps model attribute names to replacement operands
        (e.g. ``{"w": new_weights}``).  A model exposing
        ``swap_weights_(params) -> old_params`` owns the exchange itself;
        otherwise attributes are validated then assigned.  Shapes, dtypes
        and splits must match the resident operands: a mismatch would
        give every bucket step new cache keys, so it is refused with
        ``ValueError`` (a republished checkpoint is new operands, **zero
        step compiles**).  Returns the old operand
        values for rollback.  The exchange happens under the step lock:
        a mid-flight batch sees all-old or all-new weights, never a mix."""
        endpoint = self._endpoint(name)
        model = endpoint.model
        if model is None:
            raise ValueError(
                f"endpoint {name!r} was registered with a bare predict "
                "callable — weight swaps need `model=`"
            )
        if not params:
            raise ValueError("swap_weights needs at least one operand")
        with self._swap_lock:
            hook = getattr(model, "swap_weights_", None)
            if hook is not None:
                old = hook(params)
            else:
                old = {}
                for key, new in params.items():
                    if not hasattr(model, key):
                        raise ValueError(
                            f"swap_weights({name!r}): model has no operand {key!r}"
                        )
                    cur = getattr(model, key)
                    _check_swap_compat(name, key, cur, new)
                    old[key] = cur
                for key, new in params.items():
                    setattr(model, key, new)
        _STATS["swaps"] += 1
        telemetry.record_event(
            "serving_swap", endpoint=name, engine=self.name, params=sorted(params)
        )
        return old

    # -- request path ---------------------------------------------------

    def submit(
        self,
        name: str,
        x: Any,
        *,
        priority: str = "normal",
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Admit + queue one request; resolves to the caller's rows only.

        ``priority`` picks the SLO class (``"high"``/``"normal"``/
        ``"low"`` by default — low sheds first under queue pressure) and
        ``deadline_s`` sets the *client* deadline: a request still queued
        when it lapses is shed at flush (reason ``expired``) instead of
        computing an answer nobody is waiting for.

        Raises :class:`~heat_tpu_torch.serving.admission.RequestRejected` when
        shed — the documented fast-fail, never a hang."""
        endpoint = self._endpoint(name)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        batch = np.asarray(x, dtype=endpoint.dtype)
        if batch.ndim == 1:
            batch = batch.reshape(1, -1)
        if batch.ndim != 2 or batch.shape[1] != endpoint.feature_dim:
            raise ValueError(
                f"endpoint {name!r} serves (rows, {endpoint.feature_dim}) "
                f"requests, got shape {np.shape(x)}"
            )
        rows = int(batch.shape[0])
        if rows == 0:
            raise ValueError("empty request")
        try:
            if self._closed:
                raise RequestRejected("closed", None, "serving engine is closed")
            if rows > endpoint.max_batch:
                raise RequestRejected(
                    "too_large",
                    None,
                    f"{rows} rows exceed endpoint max batch {endpoint.max_batch} "
                    "(split oversized requests client-side)",
                )
            self.admission.admit(name, rows, batch.nbytes, priority=priority)
        except RequestRejected as exc:
            _STATS["rejected"] += 1
            _STATS["shed"][exc.reason] += 1
            _bump(_STATS["shed_by_class"], priority)
            telemetry.record_event(
                "serving_shed",
                endpoint=name,
                reason=exc.reason,
                rows=rows,
                priority=priority,
                retry_after_s=exc.retry_after_s,
            )
            raise
        _STATS["accepted"] += 1
        _bump(_STATS["accepted_by_class"], priority)
        now = time.perf_counter()
        request = Request(
            endpoint=name,
            payload=batch,
            rows=rows,
            t0=now,
            deadline=now + endpoint.max_delay_s,
            priority=priority,
            client_deadline=None if deadline_s is None else now + float(deadline_s),
        )
        self._batcher.enqueue(request, endpoint.max_batch)
        return request.future

    def predict(
        self,
        name: str,
        x: Any,
        timeout: Optional[float] = 30.0,
        *,
        priority: str = "normal",
    ) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``.

        The timeout doubles as the client deadline — a request that
        cannot flush in time is shed ``expired`` at flush, not left
        queued (and admitted) behind the caller's back."""
        return self.submit(name, x, priority=priority, deadline_s=timeout).result(
            timeout
        )

    # -- batch execution (batcher worker thread) ------------------------

    def _endpoint(self, name: str) -> Endpoint:
        with self._lock:
            endpoint = self._endpoints.get(name)
        if endpoint is None:
            raise KeyError(
                f"unknown serving endpoint {name!r}; registered: {list(self.endpoints())}"
            )
        return endpoint

    def _get_step(self, endpoint: Endpoint, bucket: int) -> _Step:
        key = (endpoint.name, bucket)
        with self._lock:
            step = self._steps.get(key)
            if step is not None:
                _STATS["step_hits"] += 1
                return step
            _STATS["step_compiles"] += 1
            fp = telemetry.fingerprint(
                (
                    "serving",
                    endpoint.name,
                    bucket,
                    endpoint.feature_dim,
                    str(endpoint.dtype),
                    endpoint.split,
                )
            )
            telemetry.ensure_program(
                fp,
                kind="serving_step",
                endpoint=endpoint.name,
                bucket=bucket,
                feature_dim=endpoint.feature_dim,
            )

            def run(batch: np.ndarray, _ep: Endpoint = endpoint) -> np.ndarray:
                x = factories.array(batch, split=_ep.split)
                out = _ep.predict(x)
                if isinstance(out, torch.Tensor):
                    out = out.detach().cpu()  # ht: HT002 ok — the batch's one read: the answers go back to the callers
                return out.numpy() if hasattr(out, "numpy") else np.asarray(out)  # ht: HT002 ok — the batch's one read: the answers go back to the callers

            step = _Step(run, fp, bucket)
            self._steps[key] = step
        telemetry.record_event(
            "serving_compile", endpoint=endpoint.name, bucket=bucket, fingerprint=fp
        )
        return step

    def _drop_expired(self, name: str, requests: Sequence[Request]) -> List[Request]:
        """Shed requests whose *client* deadline lapsed while queued —
        their callers have already timed out, so computing them is dead
        work that only adds latency for live requests behind them."""
        now = time.perf_counter()
        live: List[Request] = []
        for request in requests:
            if request.client_deadline is None or now < request.client_deadline:
                live.append(request)
                continue
            try:
                request.future.set_exception(
                    RequestRejected(
                        "expired",
                        None,
                        f"client deadline passed "
                        f"{now - request.client_deadline:.3f}s before flush",
                    )
                )
            except InvalidStateError:
                pass
            self.admission.release(request.rows)
            _STATS["shed"]["expired"] += 1
            _bump(_STATS["shed_by_class"], request.priority)
            telemetry.record_event(
                "serving_expired",
                endpoint=name,
                rows=request.rows,
                priority=request.priority,
            )
        return live

    def _execute(self, name: str, requests: Sequence[Request], cause: str) -> None:
        endpoint = self._endpoint(name)
        requests = self._drop_expired(name, requests)
        if not requests:
            return
        rows = sum(r.rows for r in requests)
        try:
            guard.fire("serving.step")
            if self.name:
                guard.fire(f"serving.step.{self.name}")
            bucket = endpoint.bucket_for(rows)
            batch = np.zeros((bucket, endpoint.feature_dim), dtype=endpoint.dtype)
            offset = 0
            for request in requests:
                batch[offset : offset + request.rows] = request.payload
                offset += request.rows
            _STATS["batches"] += 1
            _STATS["padded_rows"] += bucket - rows
            _STATS["flush_cause"][cause] += 1
            step = self._get_step(endpoint, bucket)
            with telemetry.span(
                "serving.batch",
                endpoint=name,
                bucket=bucket,
                rows=rows,
                requests=len(requests),
                cause=cause,
            ):
                t0 = time.perf_counter()
                # swaps exchange operands under this lock, so a batch
                # reads either all-old or all-new weights — never a tear
                with self._swap_lock:
                    out = step.run(batch)
                duration = time.perf_counter() - t0
            telemetry.record_timing(step.fingerprint, duration)
            telemetry.program_hit(step.fingerprint)
            # streamed-corpus models (KNeighborsClassifier.fit_stream)
            # measure per-pass I/O overlap; surface it on the serving
            # flight recorder next to the batch that paid for it
            stream_rep = getattr(endpoint.model, "last_stream_report", None)
            if stream_rep:
                telemetry.record_event(
                    "serving_stream", endpoint=name, bucket=bucket,
                    **stream_rep,
                )
        except BaseException as exc:  # noqa: BLE001 — every future must resolve
            for request in requests:
                try:
                    request.future.set_exception(exc)
                except InvalidStateError:
                    pass
            self.admission.release(rows)
            _STATS["step_errors"] += 1
            telemetry.record_event(
                "serving_error", endpoint=name, engine=self.name, error=repr(exc)
            )
            # a failing step is liveness, not a stall: this worker is
            # alive and resolving futures.  Without the beat, a burst of
            # consecutive step errors latched `stalled` (no successful
            # batch ever called note_progress) and shed all traffic from
            # a live worker until one batch happened to succeed.
            self.admission.note_progress()
            if self._detector is not None:
                self._detector.beat()
            return
        offset = 0
        done = time.perf_counter()
        reservoir = _LATENCIES.setdefault(
            self._lat_key(name), deque(maxlen=_LATENCY_SAMPLES)
        )
        for request in requests:
            try:
                request.future.set_result(out[offset : offset + request.rows])
            except InvalidStateError:
                pass
            offset += request.rows
            reservoir.append(done - request.t0)
            _STATS["batched"] += 1
        self.admission.release(rows)
        self.admission.note_progress()
        if self._detector is not None:
            self._detector.beat()

    # -- introspection / lifecycle --------------------------------------

    def _lat_key(self, name: str) -> str:
        return f"{self.name}:{name}" if self.name else name

    def latency(self, name: str) -> Optional[Dict[str, float]]:
        """This engine's p50/p99 reservoir snapshot for endpoint ``name``
        (``None`` before the first served batch) — named engines (fleet
        replicas) keep per-replica reservoirs, so the router routes on
        each replica's own percentiles."""
        return _latency_view().get(self._lat_key(name))

    def busy(self) -> int:
        """Queued + in-flight work (see :meth:`DynamicBatcher.busy`)."""
        return self._batcher.busy()

    def in_flight(self) -> int:
        """Batches executing right now (queued rows excluded — see
        :meth:`DynamicBatcher.in_flight`)."""
        return self._batcher.in_flight()

    @property
    def detector(self):
        """The attached :class:`~heat_tpu_torch.utils.fault.StallDetector`
        (``None`` when running without a watchdog)."""
        return self._detector

    def stats(self) -> Dict[str, Any]:
        """Live ``serving`` counter snapshot incl. latency percentiles."""
        return telemetry.snapshot_group("serving")

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: shed new work, flush or cancel the queue,
        stop the worker.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.admission.begin_drain()
        drained = True
        if drain:
            drained = self._batcher.drain(timeout=timeout)
        for request in self._batcher.cancel_pending():
            try:
                request.future.set_exception(
                    RequestRejected("closed", None, "engine closed before execution")
                )
            except InvalidStateError:
                pass
            self.admission.release(request.rows)
        self._batcher.stop()
        self.admission.close()
        self._detector = None
        _STATS["drains"] += 1
        telemetry.record_event(
            "serving_drain", drained=bool(drained), endpoints=len(self._endpoints)
        )

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
