"""Failure detection and elastic restart from a checkpoint (counterpart of
heat_tpu/utils/fault.py).

* :func:`run_elastic` — a supervised training loop: every step's result is
  health-checked (non-finite loss or metrics count as failures, exceptions
  are caught), a failure restores the latest checkpoint and reruns; a step
  that fails again right after its restore is deterministic and skipped;
  a restart budget bounds the recovery work.
* :class:`StallDetector` — a wall-clock watchdog thread: if no heartbeat
  arrives within ``timeout`` seconds (a wedged step, a hung host), a stall
  event fires and its subscribers hear of it.
* :class:`FaultInjector` — deterministic fault injection: raise at step N
  or corrupt the loss to NaN at step N, and below the training loop arm
  *sites* (:meth:`~FaultInjector.oom_in`, :meth:`~FaultInjector.error_in`,
  :meth:`~FaultInjector.nan_in`, :meth:`~FaultInjector.stall_in`) that the
  port consults through :mod:`heat_tpu_torch.core.guard` on every attempt:
  ``transport.resplit`` / ``transport.reshape`` / ``transport.take`` /
  ``transport.rechunk``, ``fusion.compile`` / ``fusion.exec``,
  ``stream.slab``, ``serving.step`` (``serving.step.<engine>`` for one
  named fleet replica) and ``serving.replica`` / ``serving.replica.<name>``.
  Installing the injector (:func:`install_injector` / :func:`injected`)
  arms them, so the OOM back-off, the eager fallback, stall shedding and
  replica failover run on faults raised at their real call sites.  A site
  key ending in ``.*`` arms every site under that prefix.

An injected out-of-memory error, :class:`InjectedOOM`, subclasses
``torch.OutOfMemoryError``: every matcher of the port that recognises the
caching allocator's failure recognises it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core import envparse, guard, memtrack, telemetry

__all__ = [
    "ElasticFailure",
    "FaultInjector",
    "InjectedOOM",
    "StallDetector",
    "clear_injector",
    "default_health_check",
    "injected",
    "install_injector",
    "run_elastic",
]


class InjectedOOM(torch.OutOfMemoryError):
    """Injected allocation failure.  It is a ``torch.OutOfMemoryError``, and
    its message carries heat_tpu's ``RESOURCE_EXHAUSTED`` marker, so the
    back-off under test is the production path, not a test double."""

    def __init__(self, site: str):
        super().__init__(f"RESOURCE_EXHAUSTED: injected OOM at {site}")
        self.site = site


class ElasticFailure(RuntimeError):
    """Raised when recovery is exhausted (restart budget spent)."""


def _leaves(value) -> Iterator[Any]:
    """The leaves of a tree of dicts, lists and tuples (``None`` is an
    empty subtree, as in a pytree)."""
    if isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    elif value is not None:
        yield value


def _map(fn, value):
    """``fn`` on every leaf of a tree of dicts, lists and tuples, the tree's
    structure kept."""
    if isinstance(value, dict):
        return type(value)((k, _map(fn, v)) for k, v in value.items())
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_map(fn, v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_map(fn, v) for v in value)
    if value is None:
        return None
    return fn(value)


def _poison(x):
    """``x`` times NaN where it is floating (or complex), else ``x``."""
    if isinstance(x, torch.Tensor):
        return x * float("nan") if (x.is_floating_point() or x.is_complex()) else x
    if hasattr(x, "larray"):  # a DNDarray
        t = x.larray
        return x * float("nan") if (t.is_floating_point() or t.is_complex()) else x
    dt = np.dtype(getattr(x, "dtype", np.float64))
    if np.issubdtype(dt, np.inexact):
        return x * dt.type(np.nan)
    return x


class FaultInjector:
    """Deterministic fault injection for exercising the recovery path.

    >>> faults = FaultInjector().raise_at(5).nan_at(9)
    >>> loss = faults.fire(step, loss)   # call inside the step

    ``raise_at`` throws ``InjectedFault`` when the step executes; ``nan_at``
    returns the loss corrupted to NaN instead.  Each fault fires once
    ("transient") unless ``sticky=True`` ("deterministic": a poisoned batch
    that fails on every retry).

    A site fault fires on the next ``times`` consultations of that site and
    then disarms; every firing is appended to :attr:`fired`.  Arm sites,
    then install the injector (:func:`injected` scopes it)::

    >>> inj = FaultInjector(seed=0).oom_in("transport.resplit", times=1)
    >>> with injected(inj):
    ...     b = a.resplit(1)          # first attempt OOMs, the back-off retries
    >>> assert inj.fired == [("oom", "transport.resplit")]
    """

    class InjectedFault(RuntimeError):
        pass

    def __init__(self, seed: Optional[int] = None):
        # seed defaults from HEAT_TPU_INJECT_SEED and is recorded for
        # reproducibility; every injection is count-deterministic, so equal
        # seeds and equal arming give identical fault schedules
        if seed is None:
            seed = envparse.env_int("HEAT_TPU_INJECT_SEED", 0, minimum=0)
        self.seed = int(seed)
        self._raises: Dict[int, bool] = {}
        self._nans: Dict[int, bool] = {}
        # site -> pending (kind, payload) faults, consumed first in first out
        self._sites: Dict[str, List[tuple]] = {}
        # simulated device readings (low_hbm), installed as memtrack's
        # stats override beside the guard hooks
        self._mem_stats: Optional[List[dict]] = None
        self.fired: List[tuple] = []

    # ---------------------------------------------- site-level injection

    def _arm(self, site: str, kind: str, payload, times: int) -> "FaultInjector":
        queue = self._sites.setdefault(str(site), [])
        queue.extend([(kind, payload)] * int(times))
        return self

    def oom_in(self, site: str, *, times: int = 1) -> "FaultInjector":
        """Raise :class:`InjectedOOM` on the next ``times`` attempts at
        ``site`` (e.g. ``transport.resplit``)."""
        return self._arm(site, "oom", None, times)

    def error_in(self, site: str, *, times: int = 1, message: str = "injected failure") -> "FaultInjector":
        """Raise a generic ``InjectedFault`` at ``site``: a failing build
        (``fusion.compile``) or run (``fusion.exec``, ``serving.step``)."""
        return self._arm(site, "error", str(message), times)

    def nan_in(self, site: str, *, times: int = 1) -> "FaultInjector":
        """Corrupt the value produced at ``site`` to NaN (floating leaves
        only)."""
        return self._arm(site, "nan", None, times)

    def stall_in(self, site: str, seconds: float, *, times: int = 1) -> "FaultInjector":
        """Sleep ``seconds`` at ``site``: a wedged step for
        :class:`StallDetector` to catch."""
        return self._arm(site, "stall", float(seconds), times)

    def low_hbm(self, free_bytes: int, *, limit: Optional[int] = None, devices: int = 1) -> "FaultInjector":
        """Simulate a memory-starved device: while this injector is
        installed, :func:`memtrack.min_free_bytes` reports ``free_bytes``
        of headroom per device, so the OOM back-off's first retry sizes its
        tile from it (also on the CPU, which reports nothing)."""
        free = int(free_bytes)
        lim = int(limit) if limit is not None else max(2 * free, free + 1)
        self._mem_stats = [
            {"device": f"injected:{i}", "bytes_limit": lim, "bytes_in_use": lim - free}
            for i in range(max(int(devices), 1))
        ]
        return self

    def _pending(self, site: str) -> Optional[List[tuple]]:
        """The armed queue for ``site``: an exact match first, then a
        prefix wildcard (``"serving.step.*"`` fires for ``serving.step.r3``)."""
        queue = self._sites.get(site)
        if queue:
            return queue
        for key, pending in self._sites.items():
            if key.endswith(".*") and pending and site.startswith(key[:-1]):
                return pending
        return None

    def fire_site(self, site: str) -> None:
        """Hook target of :func:`heat_tpu_torch.core.guard.fire`."""
        queue = self._pending(site)
        if not queue or queue[0][0] not in ("oom", "error", "stall"):
            return
        kind, payload = queue.pop(0)
        self.fired.append((kind, site))
        if kind == "oom":
            raise InjectedOOM(site)
        if kind == "error":
            raise FaultInjector.InjectedFault(f"{payload} at {site}")
        time.sleep(payload)  # stall

    def corrupt_site(self, site: str, value):
        """Hook target of :func:`heat_tpu_torch.core.guard.corrupt`."""
        queue = self._pending(site)
        if not queue or queue[0][0] != "nan":
            return value
        queue.pop(0)
        self.fired.append(("nan", site))
        return _map(_poison, value)

    # -------------------------------------------- step-level injection

    def raise_at(self, step: int, *, sticky: bool = False) -> "FaultInjector":
        self._raises[int(step)] = sticky
        return self

    def nan_at(self, step: int, *, sticky: bool = False) -> "FaultInjector":
        self._nans[int(step)] = sticky
        return self

    def fire(self, step: int, loss):
        step = int(step)
        if step in self._raises:
            if not self._raises[step]:
                del self._raises[step]
            raise FaultInjector.InjectedFault(f"injected fault at step {step}")
        if step in self._nans:
            if not self._nans[step]:
                del self._nans[step]
            return _map(lambda x: x * float("nan") if isinstance(x, torch.Tensor)
                        else np.asarray(x, dtype=np.float32) * np.nan, loss)
        return loss


class StallDetector:
    """Host-clock watchdog: fires ``on_stall`` if :meth:`beat` goes quiet.

    >>> watchdog = StallDetector(timeout=300, on_stall=callback).start()
    >>> for batch in data:
    ...     watchdog.beat()   # after each completed step
    >>> watchdog.stop()

    The callback runs on the watchdog thread.  :meth:`pause` suspends the
    watchdog for work that is legitimately quiet (a first build of a
    kernel); it nests, and works standalone or as a context manager.

    :meth:`subscribe` registers push callbacks ``cb(kind, info)`` with kind
    in ``{"stall", "recover", "pause", "resume"}``: the serving admission
    gate rides this instead of polling.  ``"recover"`` fires on the first
    beat after a stall.  Callbacks run on the thread that made the
    transition (the watchdog thread for ``"stall"``) and are dispatched
    from a snapshot taken under the lock, so a subscriber may unsubscribe
    itself mid-dispatch.
    """

    def __init__(self, timeout: float, on_stall: Optional[Callable[[float], None]] = None):
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._paused = 0
        # one lock for all of _last/_fired/_paused/_subs: a beat between
        # the watcher's quiet check and its fire must not be swallowed
        self._pause_lock = threading.Lock()
        self._subs: List[Callable[[str, dict], None]] = []
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StallDetector":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def subscribe(self, callback: Callable[[str, dict], None]) -> Callable[[str, dict], None]:
        """Register ``callback(kind, info)`` for stall-plane transitions."""
        with self._pause_lock:
            if callback not in self._subs:
                self._subs.append(callback)
        return callback

    def unsubscribe(self, callback: Callable[[str, dict], None]) -> None:
        """Remove a subscriber; an unknown callback is a no-op."""
        with self._pause_lock:
            try:
                self._subs.remove(callback)
            except ValueError:
                pass

    def _notify(self, kind: str, **info) -> None:
        with self._pause_lock:
            subs = tuple(self._subs)
        for callback in subs:
            try:
                callback(kind, dict(info))
            except Exception as exc:  # noqa: BLE001 — the watchdog must survive
                telemetry.record_event("stall_subscriber_error", kind=kind, error=repr(exc))

    def beat(self) -> None:
        with self._pause_lock:
            recovered = self._fired
            self._last = time.monotonic()
            self._fired = False
        telemetry.record_event("heartbeat")
        if recovered:
            self._notify("recover", timeout_s=self.timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 1.0)

    def pause(self) -> "_StallPause":
        """Suspend stall detection; nests.  Returns a context manager whose
        exit calls :meth:`resume`."""
        with self._pause_lock:
            self._paused += 1
            depth = self._paused
        telemetry.record_event("stall_pause", depth=depth)
        self._notify("pause", depth=depth)
        return _StallPause(self)

    def resume(self) -> None:
        """Undo one :meth:`pause`; re-arms the clock when the last pause
        lifts, so paused time never counts as quiet time."""
        with self._pause_lock:
            self._last = time.monotonic()
            self._fired = False
            self._paused = max(0, self._paused - 1)
            depth = self._paused
        telemetry.record_event("stall_resume", depth=depth)
        self._notify("resume", depth=depth)

    def _watch(self) -> None:
        poll = min(0.05, self.timeout / 4)
        while not self._stop.wait(poll):
            with self._pause_lock:
                if self._paused:
                    continue
                quiet = time.monotonic() - self._last
                if quiet <= self.timeout or self._fired:
                    continue
                self._fired = True  # once per stall, not once per poll
            telemetry.record_event("stall", quiet_s=round(quiet, 3), timeout_s=self.timeout,
                                   open_spans=telemetry.open_spans())
            telemetry.postmortem("stall")
            if self.on_stall is not None:
                self.on_stall(quiet)
            self._notify("stall", quiet_s=round(quiet, 3), timeout_s=self.timeout)


class _StallPause:
    """The context-manager half of :meth:`StallDetector.pause`."""

    def __init__(self, detector: StallDetector):
        self._detector = detector

    def __enter__(self) -> StallDetector:
        return self._detector

    def __exit__(self, *exc) -> bool:
        self._detector.resume()
        return False


# ------------------------------------------------ injector installation
# The guard hooks are consulted at every transport attempt, fused
# execution, streamed slab and serving dispatch; installing an injector
# arms them process-wide.


def install_injector(injector: FaultInjector) -> FaultInjector:
    """Arm the guard hooks with ``injector`` (process-wide); one carrying
    :meth:`~FaultInjector.low_hbm` readings also installs them as
    memtrack's device-stats override."""
    guard._INJECTOR = injector
    if injector._mem_stats is not None:
        memtrack.set_stats_override(injector._mem_stats)
    return injector


def clear_injector() -> None:
    """Disarm the guard hooks (and any simulated memory readings)."""
    guard._INJECTOR = None
    memtrack.set_stats_override(None)


@contextmanager
def injected(injector: FaultInjector):
    """Scoped :func:`install_injector`::

    >>> with injected(FaultInjector().oom_in("transport.resplit")):
    ...     b = a.resplit(1)
    """
    prev = guard._INJECTOR
    guard._INJECTOR = injector
    has_mem = injector._mem_stats is not None
    prev_mem = memtrack.set_stats_override(injector._mem_stats) if has_mem else None
    try:
        yield injector
    finally:
        guard._INJECTOR = prev
        if has_mem:
            memtrack.set_stats_override(prev_mem)


def _host_values(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return np.zeros(0)
        return leaf.to(torch.complex128 if leaf.is_complex() else torch.float64).cpu().numpy()
    if hasattr(leaf, "larray"):  # a DNDarray
        return _host_values(leaf.larray)
    return np.asarray(leaf)


def default_health_check(metrics: Any) -> bool:
    """Healthy iff every floating (real or complex) leaf of ``metrics`` is
    finite."""
    for leaf in _leaves(metrics):
        arr = _host_values(leaf)
        if np.issubdtype(arr.dtype, np.inexact) and not np.isfinite(arr).all():
            return False
    return True


@dataclass
class ElasticReport:
    """What happened during a :func:`run_elastic` run."""

    steps_run: int = 0
    restarts: int = 0
    skipped_steps: List[int] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)

    def record(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})


def run_elastic(
    step_fn: Callable[[Any, Any], tuple],
    init_state: Any,
    batch_fn: Callable[[int], Any],
    n_steps: int,
    *,
    checkpointer=None,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    health_check: Callable[[Any], bool] = default_health_check,
    on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
):
    """Run ``n_steps`` of training under failure supervision.

    Args:
        step_fn: ``(state, batch) -> (state, metrics)``; exceptions and
            non-finite metrics are step failures.
        init_state: the starting state (a tree the checkpointer can save).
        batch_fn: ``step -> batch``; called once per attempted step, so the
            data order is reproducible across restarts.
        n_steps: total steps to run.
        checkpointer: a :class:`heat_tpu_torch.utils.checkpointing.Checkpointer`;
            ``None`` recovers by rewinding to ``init_state`` (step 0).
        checkpoint_every: save cadence in steps (ignored without one).
        max_restarts: the recovery budget; exceeding it raises
            :class:`ElasticFailure`.
        health_check: predicate on the step's metrics; by default every
            floating leaf is finite.
        on_event: optional callback receiving each event dict as recorded.
        on_step: optional callback ``(step, metrics)`` after each
            successful step (the place to beat a :class:`StallDetector`).

    Returns:
        ``(state, report)``: the final state and an :class:`ElasticReport`.

    A step that fails again right after its restore is deterministic in
    its (state, batch) pair: it is skipped in place (the pre-step state is
    intact, no restore, no budget charge) and listed in
    ``report.skipped_steps``.
    """

    def emit(report: ElasticReport, kind: str, **info) -> None:
        report.record(kind, **info)
        if on_event is not None:
            on_event(report.events[-1])

    report = ElasticReport()
    state = init_state
    step = 0
    last_saved = None
    last_failed_step = None

    if checkpointer is not None:
        restored = checkpointer.restore_latest(target={"state": init_state, "step": 0})
        if restored is not None:
            state, step = restored["state"], int(restored["step"])
            last_saved = step
            emit(report, "resume", step=step)

    while step < n_steps:
        if step in report.skipped_steps:
            step += 1
            continue
        try:
            new_state, metrics = step_fn(state, batch_fn(step))
            # the metrics read to the host: a non-finite value surfaces now,
            # while recovery is still possible
            if not health_check(metrics):  # ht: HT002 ok — the health check needs the metrics on the host while recovery is possible
                raise _UnhealthyStep(f"health check failed at step {step}")
        except Exception as exc:  # noqa: BLE001 — any step failure recovers
            if step == last_failed_step:
                report.skipped_steps.append(step)
                emit(report, "skip", step=step, error=repr(exc))
                last_failed_step = None
                step += 1
                continue
            if report.restarts >= max_restarts:
                emit(report, "give_up", step=step, error=repr(exc))
                raise ElasticFailure(f"restart budget ({max_restarts}) exhausted at step {step}: {exc!r}") from exc
            report.restarts += 1
            emit(report, "failure", step=step, error=repr(exc))
            last_failed_step = step
            restored = None
            if checkpointer is not None and last_saved is not None:
                restored = checkpointer.restore_latest(target={"state": init_state, "step": 0})
            if restored is not None:
                state, step = restored["state"], int(restored["step"])
                emit(report, "restore", step=step)
            else:
                # no checkpoint yet (or it was removed): rewind to the start
                state, step = init_state, 0
                emit(report, "rewind", step=0)
            continue

        state = new_state
        step += 1
        report.steps_run += 1
        if on_step is not None:
            on_step(step, metrics)
        if checkpointer is not None and checkpoint_every > 0 and step % checkpoint_every == 0:
            checkpointer.save(step, {"state": state, "step": step})
            last_saved = step

    return state, report


class _UnhealthyStep(RuntimeError):
    pass
