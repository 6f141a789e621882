"""Fault-tolerant fleet router: health-checked replicas, failover,
SLO-aware dispatch and zero-downtime weight swaps (counterpart of
heat_tpu/serving/router.py).

A :class:`ServingFleet` fronts N :class:`~heat_tpu_torch.serving.engine
.ServingEngine` replicas, each with its own admission gate, batcher worker
and :class:`~heat_tpu_torch.utils.fault.StallDetector`, behind one
``submit``/``predict`` surface:

* **placement**: a consistent-hash ring (SHA-1, virtual nodes) maps a
  request key to its *home* replica, so repeat keys hit warm caches; when
  the home's load (queued rows plus in-flight batches over its queue bound)
  crosses ``spill_load``, the request spills to the least-loaded healthy
  sibling.
* **health**: a per-replica circuit breaker driven by real signals: the
  replica's StallDetector (a stall on a busy replica ejects it; a stall on
  an idle one is just quiet and re-arms the clock), consecutive step-error
  bursts, and admission sheds.  States run healthy → degraded → ejected →
  half-open → healthy; an ejected replica re-enters only after a
  **probation probe** (one real request through the full stack) succeeds.
* **failover**: a replica failure or stall mid-flight re-dispatches the
  request to a healthy sibling: callers see added latency, never a lost
  future.  :class:`RequestRejected` with ``retry_after_s`` gets jittered
  exponential backoff (the jitter from a seeded generator); both paths are
  bounded by ``max_retries`` per request and a fleet-wide token **retry
  budget** refilled by successes.
* **swaps**: :meth:`ServingFleet.rolling_swap` promotes new weights
  canary-first, advances only while the swapped replicas' probes stay
  healthy, and rolls back on a probe error or a latency regression; each
  replica's ``engine.swap_weights`` exchanges operands under its step lock
  with **zero step compiles**.
* **tuning**: the replicas' tuning caches are folded by
  :func:`heat_tpu_torch.core.autotune.merge` on the router's housekeeping
  thread, so every replica warm-starts from the fleet's best timings.

The replicas of a fleet on one card share it: their steps queue on the
card's one stream, so a fleet shows the routing, health and failover
machinery, not more device throughput.

Telemetry: the ``router`` counter group (dispatch/spill/failover/retry,
circuit transitions, swap outcomes) exports as ``heat_tpu_router_*``
gauges; flight-recorder events ``router_health`` / ``router_failover`` /
``router_probe`` / ``router_swap`` / ``router_rollback`` name every
transition.  Failure paths are driven by
:class:`~heat_tpu_torch.utils.fault.FaultInjector` sites ``serving.replica``
(per dispatch) and ``serving.step`` (per batch).
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Container,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

import numpy as np

from ..core import guard, telemetry
from ..utils import fault
from .admission import AdmissionController, RequestRejected
from .engine import ServingEngine

__all__ = ["Replica", "ServingFleet"]

#: replica health states (strings so snapshots/events stay greppable)
HEALTHY = "healthy"
DEGRADED = "degraded"
EJECTED = "ejected"
HALF_OPEN = "half_open"

_STATS = telemetry.register_group(
    "router",
    {
        "dispatched": 0,
        "dispatched_by_class": {"high": 0, "normal": 0, "low": 0},
        "spills": 0,
        "retries": 0,
        "failovers": 0,
        "backoffs": 0,
        "rejected": 0,
        "late_results": 0,
        "lost_futures": 0,
        "retry_budget_exhausted": 0,
        "degradations": 0,
        "ejections": 0,
        "half_opens": 0,
        "probes": 0,
        "probe_failures": 0,
        "recoveries": 0,
        "swaps": 0,
        "rollbacks": 0,
        "cache_merges": 0,
    },
)


def _bump(counter: Dict[str, int], key: str) -> None:
    counter[key] = counter.get(key, 0) + 1


def _hash64(token: str) -> int:
    return int.from_bytes(hashlib.sha1(token.encode()).digest()[:8], "big")


class Replica:
    """One engine plus its circuit-breaker bookkeeping (router-owned)."""

    def __init__(self, name: str, engine: ServingEngine, detector):
        self.name = name
        self.engine = engine
        self.detector = detector
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.ejected_until = 0.0
        self.probe_in_flight = False

    def load(self) -> float:
        """Queued rows + in-flight batches over the queue bound — the
        spill signal.  In-flight batches count so a replica grinding a
        slow step looks loaded even with an empty queue."""
        admission = self.engine.admission
        return (admission.queued_rows + self.engine.busy()) / max(
            1, admission.max_queue_rows
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "load": round(self.load(), 4),
            "consecutive_failures": self.consecutive_failures,
        }


@dataclass
class _FleetRequest:
    """One caller-visible request; may ride several replica dispatches."""

    endpoint: str
    payload: Any
    priority: str
    deadline: Optional[float]  # absolute perf_counter instant, or None
    key: Any
    future: Future = field(default_factory=Future)
    attempts: int = 0
    tried: Set[str] = field(default_factory=set)


class ServingFleet:
    """N health-checked serving replicas behind one front door.

    >>> fleet = ServingFleet(replicas=4)
    >>> fleet.register("centers", models=[m0, m1, m2, m3],
    ...                feature_dim=32, warm=True)
    >>> y = fleet.predict("centers", x)                  # routed
    >>> fut = fleet.submit("centers", x, priority="low", deadline_s=0.5)
    >>> report = fleet.rolling_swap("centers", {"w": new_w}, canary=1)

    Usable as a context manager; exit drains every replica.
    """

    def __init__(
        self,
        replicas: Any = 2,
        *,
        stall_timeout_s: float = 1.0,
        error_threshold: int = 3,
        cooldown_s: float = 0.5,
        spill_load: float = 0.75,
        max_retries: int = 2,
        retry_budget: float = 32.0,
        retry_refill: float = 0.1,
        backoff_base_s: float = 0.01,
        backoff_max_s: float = 0.25,
        probe_timeout_s: float = 5.0,
        vnodes: int = 32,
        admission_kwargs: Optional[Dict[str, Any]] = None,
        default_max_delay_s: float = 0.005,
        autotune_caches: Optional[Sequence[str]] = None,
        autotune_merge_out: Optional[str] = None,
        merge_every_s: float = 2.0,
    ):
        if error_threshold < 1:
            raise ValueError(f"error_threshold must be >= 1, got {error_threshold}")
        self.stall_timeout_s = float(stall_timeout_s)
        self.error_threshold = int(error_threshold)
        self.cooldown_s = float(cooldown_s)
        self.spill_load = float(spill_load)
        self.max_retries = int(max_retries)
        self.retry_budget = float(retry_budget)
        self.retry_refill = float(retry_refill)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._autotune_caches = list(autotune_caches or [])
        self._autotune_merge_out = autotune_merge_out
        self._merge_every_s = float(merge_every_s)
        self._merge_elapsed = 0.0

        if isinstance(replicas, int):
            if replicas < 1:
                raise ValueError(f"need at least one replica, got {replicas}")
            engines = [
                ServingEngine(
                    name=f"r{i}",
                    admission=AdmissionController(**(admission_kwargs or {})),
                    default_max_delay_s=default_max_delay_s,
                )
                for i in range(replicas)
            ]
        else:
            engines = list(replicas)
            if not engines:
                raise ValueError("need at least one replica engine")
            for i, engine in enumerate(engines):
                if not getattr(engine, "name", ""):
                    engine.name = f"r{i}"
            names = [engine.name for engine in engines]
            if len(set(names)) != len(names):
                raise ValueError(f"replica engine names must be unique, got {names}")

        self._lock = threading.RLock()
        self._closed = False
        self._retry_tokens = self.retry_budget
        # deterministic jitter: count-deterministic like the injector's
        # fault schedules, so backoff traces replay bit for bit
        self._rng = random.Random(fault.FaultInjector().seed or 20)
        self._endpoints: Dict[str, Dict[str, Any]] = {}
        self._inflight: Dict[Tuple[int, str], Tuple[_FleetRequest, "Replica"]] = {}
        self._timers: Dict[threading.Timer, _FleetRequest] = {}
        self._keyseq = itertools.count()

        self._replicas: List[Replica] = []
        for engine in engines:
            detector = engine.detector
            if detector is None:
                detector = fault.StallDetector(timeout=self.stall_timeout_s)
                engine.attach_stall_detector(detector)
                detector.start()
            replica = Replica(engine.name, engine, detector)
            detector.subscribe(self._detector_handler(replica))
            self._replicas.append(replica)

        self._ring: List[Tuple[int, Replica]] = []
        for replica in self._replicas:
            for v in range(max(1, int(vnodes))):
                self._ring.append((_hash64(f"{replica.name}#{v}"), replica))
        self._ring.sort(key=lambda pair: pair[0])
        self._ring_keys = [h for h, _ in self._ring]

        self._stop = threading.Event()
        self._housekeeper = threading.Thread(
            target=self._housekeep, name="heat-tpu-torch-fleet-housekeeper", daemon=True
        )
        self._housekeeper.start()

    # -- registry -------------------------------------------------------

    @property
    def replicas(self) -> Tuple[Replica, ...]:
        return tuple(self._replicas)

    def register(
        self,
        name: str,
        model: Any = None,
        *,
        models: Optional[Sequence[Any]] = None,
        predict: Optional[Callable[[Any], Any]] = None,
        feature_dim: int,
        dtype: Any = np.float32,
        **kwargs: Any,
    ) -> None:
        """Register endpoint ``name`` on every replica.

        Pass ``models=`` (one fitted model per replica) for rolling
        swaps — a single shared ``model`` object serves fine but cannot
        canary (swapping one replica would swap them all), and
        ``rolling_swap`` refuses it.  Remaining ``kwargs`` forward to
        :meth:`ServingEngine.register` (buckets, ``warm=``, ...)."""
        if models is not None and model is not None:
            raise ValueError("pass `model=` or `models=`, not both")
        if models is not None and len(models) != len(self._replicas):
            raise ValueError(
                f"models= needs one model per replica "
                f"({len(self._replicas)}), got {len(models)}"
            )
        for i, replica in enumerate(self._replicas):
            replica.engine.register(
                name,
                models[i] if models is not None else model,
                predict=predict,
                feature_dim=feature_dim,
                dtype=dtype,
                **kwargs,
            )
        self._endpoints[name] = {
            "feature_dim": int(feature_dim),
            "dtype": np.dtype(dtype),
            "shared_model": models is None and model is not None,
        }

    def endpoints(self) -> Tuple[str, ...]:
        return tuple(sorted(self._endpoints))

    def warmup(self, name: str) -> int:
        """Warm every replica's bucket ladder; returns buckets/replica."""
        buckets = 0
        for replica in self._replicas:
            buckets = replica.engine.warmup(name)
        return buckets

    # -- request path ---------------------------------------------------

    def submit(
        self,
        name: str,
        x: Any,
        *,
        priority: str = "normal",
        deadline_s: Optional[float] = None,
        key: Any = None,
    ) -> Future:
        """Route one request; the Future resolves from whichever replica
        finally serves it.  ``key`` pins ring placement (e.g. a user or
        shard id) — omitted, placement round-robins.  Raises
        :class:`RequestRejected` only when no dispatch is possible at
        all; transient sheds are retried/failed-over internally."""
        if self._closed:
            raise RequestRejected("closed", None, "serving fleet is closed")
        if name not in self._endpoints:
            raise KeyError(
                f"unknown fleet endpoint {name!r}; registered: {list(self.endpoints())}"
            )
        now = time.perf_counter()
        request = _FleetRequest(
            endpoint=name,
            payload=x,
            priority=priority,
            deadline=None if deadline_s is None else now + float(deadline_s),
            key=key if key is not None else next(self._keyseq),
        )
        self._dispatch(request)
        return request.future

    def predict(
        self,
        name: str,
        x: Any,
        timeout: Optional[float] = 30.0,
        *,
        priority: str = "normal",
        key: Any = None,
    ) -> np.ndarray:
        """Blocking convenience; the timeout is also the client deadline."""
        return self.submit(
            name, x, priority=priority, deadline_s=timeout, key=key
        ).result(timeout)

    # -- placement ------------------------------------------------------

    def _ring_order(self, key: Any) -> List[Replica]:
        """Replicas in ring order starting at ``key``'s successor."""
        start = bisect.bisect_right(self._ring_keys, _hash64(str(key)))
        seen: Set[str] = set()
        order: List[Replica] = []
        for i in range(len(self._ring)):
            _, replica = self._ring[(start + i) % len(self._ring)]
            if replica.name not in seen:
                seen.add(replica.name)
                order.append(replica)
                if len(order) == len(self._replicas):
                    break
        return order

    def _route(
        self, request: _FleetRequest, exclude: Container[str] = ()
    ) -> Optional[Replica]:
        with self._lock:
            # degraded replicas still serve their home traffic — the
            # state is a warning, and starving them would freeze the
            # consecutive-failure counter short of the breaker threshold
            # (and the success that would clear the state).  Only
            # ejected/half-open replicas are benched.  ``exclude`` holds
            # this attempt's back-pressure (a replica that just shed
            # queue_full/hbm_pressure) — transient, unlike ``tried``.
            candidates = [
                replica
                for replica in self._ring_order(request.key)
                if replica.state in (HEALTHY, DEGRADED)
                and replica.name not in request.tried
                and replica.name not in exclude
            ]
            if not candidates:
                return None
            home = candidates[0]
            if len(candidates) > 1 and home.load() >= self.spill_load:
                healthy = [r for r in candidates if r.state == HEALTHY]
                alternate = min(healthy or candidates, key=lambda r: r.load())
                if alternate is not home and alternate.load() < home.load():
                    _STATS["spills"] += 1
                    return alternate
            return home

    # -- dispatch / failover --------------------------------------------

    def _dispatch(
        self, request: _FleetRequest, exclude: Container[str] = ()
    ) -> None:
        if request.future.done():
            return
        replica = self._route(request, exclude)
        if replica is None:
            self._fail(
                request,
                RequestRejected(
                    "unavailable",
                    self.cooldown_s,
                    "no healthy replica available (ejected or already tried)",
                ),
            )
            return
        request.attempts += 1
        _STATS["dispatched"] += 1
        _bump(_STATS["dispatched_by_class"], request.priority)
        try:
            guard.fire("serving.replica")
            guard.fire(f"serving.replica.{replica.name}")
            remaining = None
            if request.deadline is not None:
                remaining = request.deadline - time.perf_counter()
                if remaining <= 0:
                    raise RequestRejected(
                        "expired", None, "client deadline passed before dispatch"
                    )
            engine_future = replica.engine.submit(
                request.endpoint,
                request.payload,
                priority=request.priority,
                deadline_s=remaining,
            )
        except RequestRejected as exc:
            self._on_reject(request, replica, exc)
            return
        except Exception as exc:  # noqa: BLE001 — injected/replica faults
            self._record_failure(replica, f"dispatch: {exc!r}")
            request.tried.add(replica.name)
            self._retry(request, exc, failover=True)
            return
        with self._lock:
            self._inflight[(id(request), replica.name)] = (request, replica)
        engine_future.add_done_callback(
            lambda f, req=request, rep=replica: self._on_result(req, rep, f)
        )

    def _on_result(self, request: _FleetRequest, replica: Replica, engine_future: Future) -> None:
        with self._lock:
            self._inflight.pop((id(request), replica.name), None)
        exc = engine_future.exception()
        if exc is None:
            self._record_success(replica)
            try:
                request.future.set_result(engine_future.result())
            except InvalidStateError:
                # already failed-over elsewhere; the slow twin landed late
                _STATS["late_results"] += 1
            return
        if request.future.done():
            _STATS["late_results"] += 1
            if not isinstance(exc, RequestRejected):
                self._record_failure(replica, repr(exc))
            return
        if isinstance(exc, RequestRejected):
            self._on_reject(request, replica, exc)
        else:
            self._record_failure(replica, repr(exc))
            request.tried.add(replica.name)
            self._retry(request, exc, failover=True)

    def _on_reject(
        self, request: _FleetRequest, replica: Replica, exc: RequestRejected
    ) -> None:
        if exc.reason in ("expired", "too_large", "closed"):
            # retrying cannot help: the deadline is gone, the shape is
            # wrong, or the replica is shutting down for good
            self._fail(request, exc)
            return
        self._record_shed(replica, exc.reason)
        with self._lock:
            sibling = any(
                r is not replica
                and r.state in (HEALTHY, DEGRADED)
                and r.name not in request.tried
                for r in self._replicas
            )
        # back-pressure, not failure: always BACK OFF (an immediate hop
        # during a load spike touching every replica would burn the
        # whole retry allowance in milliseconds), and when a sibling
        # exists, exclude the shedding replica from the next attempt
        # only — marking it ``tried`` for good would turn that same
        # spike into a terminal `unavailable`.
        exclude = {replica.name} if sibling else ()
        self._retry(request, exc, failover=False, exclude=exclude)

    def _retry(
        self,
        request: _FleetRequest,
        exc: Exception,
        *,
        failover: bool,
        exclude: Container[str] = (),
        charge: bool = True,
    ) -> None:
        if request.future.done():
            return
        if request.attempts > self.max_retries:
            self._fail(request, exc)
            return
        with self._lock:
            if self._closed:
                self._fail(request, exc)
                return
            # ``charge=False`` is the evacuation path: when a replica
            # dies mid-flight, EVERY victim re-dispatches regardless of
            # the token bucket — a mass failover after one failure is
            # the never-lose-a-future guarantee, not a retry storm.
            # The bucket throttles repeated per-request retries only.
            if charge:
                if self._retry_tokens < 1.0:
                    _STATS["retry_budget_exhausted"] += 1
                    self._fail(request, exc)
                    return
                self._retry_tokens -= 1.0
        _STATS["retries"] += 1
        if failover:
            _STATS["failovers"] += 1
            telemetry.record_event(
                "router_failover",
                endpoint=request.endpoint,
                attempt=request.attempts,
                error=repr(exc),
            )
            self._dispatch(request, exclude)
            return
        _STATS["backoffs"] += 1
        wait = min(
            self.backoff_max_s,
            self.backoff_base_s * (2 ** max(0, request.attempts - 1)),
        ) * (0.5 + self._rng.random())
        if isinstance(exc, RequestRejected) and exc.retry_after_s:
            wait = max(wait, exc.retry_after_s)
        timer_box: Dict[str, threading.Timer] = {}

        def _fire() -> None:
            with self._lock:
                self._timers.pop(timer_box["t"], None)
            self._dispatch(request, exclude)

        timer = threading.Timer(wait, _fire)
        timer.daemon = True
        timer_box["t"] = timer
        with self._lock:
            if self._closed:
                self._fail(request, exc)
                return
            self._timers[timer] = request
        timer.start()

    def _fail(self, request: _FleetRequest, exc: Exception) -> None:
        _STATS["rejected"] += 1
        try:
            request.future.set_exception(exc)
        except InvalidStateError:
            _STATS["late_results"] += 1

    # -- health state machine -------------------------------------------

    def _set_state(self, replica: Replica, state: str, reason: str) -> None:
        # caller holds self._lock
        previous = replica.state
        if previous == state:
            return
        replica.state = state
        telemetry.record_event(
            "router_health",
            replica=replica.name,
            previous=previous,
            state=state,
            reason=reason,
        )

    def _eject_locked(self, replica: Replica, reason: str) -> None:
        if replica.state != EJECTED:
            _STATS["ejections"] += 1
        replica.ejected_until = time.perf_counter() + self.cooldown_s
        self._set_state(replica, EJECTED, reason)

    def _record_failure(self, replica: Replica, reason: str) -> None:
        with self._lock:
            replica.consecutive_failures += 1
            if replica.state == HALF_OPEN:
                # probation failed — back to the bench, fresh cooldown
                self._eject_locked(replica, f"half-open failure: {reason}")
            elif replica.consecutive_failures >= self.error_threshold:
                self._eject_locked(
                    replica,
                    f"{replica.consecutive_failures} consecutive failures: {reason}",
                )
            elif replica.state == HEALTHY:
                _STATS["degradations"] += 1
                self._set_state(replica, DEGRADED, reason)

    def _record_shed(self, replica: Replica, reason: str) -> None:
        with self._lock:
            if replica.state == HEALTHY:
                _STATS["degradations"] += 1
                self._set_state(replica, DEGRADED, f"shed: {reason}")

    def _record_success(self, replica: Replica) -> None:
        with self._lock:
            replica.consecutive_failures = 0
            self._retry_tokens = min(
                self.retry_budget, self._retry_tokens + self.retry_refill
            )
            if replica.state == DEGRADED:
                self._set_state(replica, HEALTHY, "served")

    def _detector_handler(self, replica: Replica):
        def _on_event(kind: str, info: Dict[str, Any]) -> None:
            if kind != "stall":
                return
            if replica.engine.in_flight() == 0:
                # nothing is executing ⇒ the step can't be wedged.  An
                # idle replica emits no heartbeats, and queued rows
                # waiting out an endpoint's ``max_delay_s`` flush window
                # are batching latency, not a hang.  Clear the engine's
                # stall latch and re-arm the clock — otherwise traffic
                # hashing elsewhere would eject every idle sibling, and
                # a long flush window would eject its own replica.
                replica.engine.admission.note_progress()
                replica.detector.beat()
                return
            with self._lock:
                self._eject_locked(
                    replica, f"stall ({info.get('quiet_s', '?')}s quiet)"
                )
                victims = [
                    req
                    for (req, rep) in self._inflight.values()
                    if rep is replica and not req.future.done()
                ]
            for victim in victims:
                victim.tried.add(replica.name)
                self._retry(
                    victim,
                    RuntimeError(f"replica {replica.name} stalled mid-flight"),
                    failover=True,
                    charge=False,
                )

        return _on_event

    # -- housekeeping: probes + autotune folding ------------------------

    def _housekeep(self) -> None:
        poll = max(0.01, min(0.05, self.cooldown_s / 4))
        while not self._stop.wait(poll):
            now = time.perf_counter()
            to_probe: List[Replica] = []
            with self._lock:
                for replica in self._replicas:
                    if (
                        replica.state == EJECTED
                        and now >= replica.ejected_until
                        and not replica.probe_in_flight
                    ):
                        _STATS["half_opens"] += 1
                        self._set_state(replica, HALF_OPEN, "cooldown elapsed")
                        replica.probe_in_flight = True
                        to_probe.append(replica)
                    elif replica.state == HALF_OPEN and not replica.probe_in_flight:
                        replica.probe_in_flight = True
                        to_probe.append(replica)
            for replica in to_probe:
                self._probe(replica)
            self._merge_elapsed += poll
            if (
                self._autotune_merge_out
                and self._autotune_caches
                and self._merge_elapsed >= self._merge_every_s
            ):
                self._merge_elapsed = 0.0
                self._merge_caches()

    def _probe(self, replica: Replica) -> None:
        """One real request through the full stack decides probation."""
        if not self._endpoints:
            # nothing registered yet — nothing the replica could fail at
            with self._lock:
                replica.probe_in_flight = False
                replica.consecutive_failures = 0
                self._set_state(replica, HEALTHY, "no endpoints to probe")
            return
        name = next(iter(self._endpoints))
        meta = self._endpoints[name]
        probe_x = np.zeros((1, meta["feature_dim"]), dtype=meta["dtype"])
        _STATS["probes"] += 1
        try:
            replica.engine.predict(
                name, probe_x, timeout=self.probe_timeout_s, priority="high"
            )
        except Exception as exc:  # noqa: BLE001 — any probe failure re-ejects
            _STATS["probe_failures"] += 1
            telemetry.record_event(
                "router_probe", replica=replica.name, ok=False, error=repr(exc)
            )
            with self._lock:
                replica.probe_in_flight = False
                self._eject_locked(replica, f"probe failed: {exc!r}")
        else:
            telemetry.record_event("router_probe", replica=replica.name, ok=True)
            with self._lock:
                replica.probe_in_flight = False
                replica.consecutive_failures = 0
                _STATS["recoveries"] += 1
                self._set_state(replica, HEALTHY, "probe succeeded")

    def _merge_caches(self) -> None:
        from ..core import autotune

        try:
            autotune.merge(self._autotune_caches, self._autotune_merge_out)
        except Exception as exc:  # noqa: BLE001 — folding is best-effort
            telemetry.record_event("router_merge_error", error=repr(exc))
        else:
            _STATS["cache_merges"] += 1

    # -- zero-downtime weight swaps -------------------------------------

    def rolling_swap(
        self,
        name: str,
        params: Dict[str, Any],
        *,
        canary: int = 1,
        probes: int = 3,
        regression_ratio: float = 5.0,
    ) -> Dict[str, Any]:
        """Fleet-wide weight swap, canary-first, with automatic rollback.

        Swaps ``canary`` replicas, then probes each swapped replica with
        ``probes`` real single-row requests; advance is health-gated — a
        probe error, or a median probe wall above ``regression_ratio ×``
        the replica's pre-swap p50 (reservoir when warm, else measured),
        rolls **every** swapped replica back to its old operands and
        returns ``rolled_back=True`` with the reason.  Succeeding, every
        replica serves the new weights with zero step compiles."""
        if name not in self._endpoints:
            raise KeyError(f"unknown fleet endpoint {name!r}")
        if self._endpoints[name]["shared_model"]:
            raise ValueError(
                f"rolling_swap({name!r}): replicas share one model object — "
                "register with models=[...] (one per replica) so a canary "
                "swap does not swap the whole fleet at once"
            )
        if not 1 <= canary <= len(self._replicas):
            raise ValueError(
                f"canary must be in [1, {len(self._replicas)}], got {canary}"
            )
        swapped: List[Tuple[Replica, Dict[str, Any]]] = []
        report: Dict[str, Any] = {
            "endpoint": name,
            "canary": canary,
            "swapped": [],
            "rolled_back": False,
            "reason": None,
        }
        for index, replica in enumerate(self._replicas):
            baseline = replica.engine.latency(name)
            baseline_s = baseline["p50_s"] if baseline else None
            if baseline_s is None:
                baseline_s = self._probe_wall(replica, name, probes)
            old = replica.engine.swap_weights(name, params)
            swapped.append((replica, old))
            _STATS["swaps"] += 1
            telemetry.record_event(
                "router_swap",
                endpoint=name,
                replica=replica.name,
                stage="canary" if index < canary else "fleet",
            )
            ok, why = True, None
            try:
                probe_s = self._probe_wall(replica, name, probes)
            except Exception as exc:  # noqa: BLE001 — probe errors gate advance
                ok, why = False, f"probe failed on {replica.name}: {exc!r}"
            else:
                # 100µs floor: a cold reservoir p50 of ~0 would flag any
                # real wall as a regression
                limit = regression_ratio * max(baseline_s, 1e-4)
                if probe_s > limit:
                    ok, why = False, (
                        f"latency regression on {replica.name}: probe p50 "
                        f"{probe_s:.6f}s > {regression_ratio:g}x baseline "
                        f"{baseline_s:.6f}s"
                    )
            if not ok:
                for back, old_params in reversed(swapped):
                    back.engine.swap_weights(name, old_params)
                _STATS["rollbacks"] += 1
                telemetry.record_event(
                    "router_rollback", endpoint=name, replica=replica.name, reason=why
                )
                report.update(rolled_back=True, reason=why, swapped=[])
                return report
            report["swapped"].append(replica.name)
        return report

    def _probe_wall(self, replica: Replica, name: str, probes: int) -> float:
        meta = self._endpoints[name]
        probe_x = np.zeros((1, meta["feature_dim"]), dtype=meta["dtype"])
        walls: List[float] = []
        for _ in range(max(1, int(probes))):
            t0 = time.perf_counter()
            replica.engine.predict(
                name, probe_x, timeout=self.probe_timeout_s, priority="high"
            )
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[len(walls) // 2]

    # -- introspection / lifecycle --------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Live ``router`` counters plus per-replica health/load."""
        snapshot = telemetry.snapshot_group("router")
        snapshot["replicas"] = {
            replica.name: replica.snapshot() for replica in self._replicas
        }
        return snapshot

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop housekeeping, fail queued backoff retries, drain every
        replica.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            timers = dict(self._timers)
            self._timers.clear()
        for timer, request in timers.items():
            timer.cancel()
            self._fail(
                request,
                RequestRejected("closed", None, "fleet closed before retry fired"),
            )
        self._stop.set()
        self._housekeeper.join(timeout=5.0)
        for replica in self._replicas:
            replica.detector.stop()
            replica.engine.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.close()
        return False
