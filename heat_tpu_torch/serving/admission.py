"""Admission control for the serving front door: bounded queues, load
shedding and stall-aware fast-fail (counterpart of
heat_tpu/serving/admission.py).

The controller is the *decision* layer only: it never touches the device
and never blocks.  :meth:`AdmissionController.admit` either returns (the
request may be queued) or raises :class:`RequestRejected` with a
machine-readable reason and a ``retry_after_s`` hint.  Three pressure
signals feed the decision:

* **queue depth**: accepted-but-unfinished rows are capped at
  ``max_queue_rows``; beyond that the queue only adds latency, so new work
  is shed (``queue_full``).
* **device memory headroom**: :func:`heat_tpu_torch.core.memtrack.would_fit`
  projects the request's staging bytes against the measured free-memory
  budget (``hbm_pressure``).  Where no device reports (the CPU) it returns
  ``None`` and the gate admits: never shed on made-up numbers.  On the card
  the reading is the caching allocator's host-side counters, no wait for
  the card.
* **liveness**: a :class:`heat_tpu_torch.utils.fault.StallDetector`
  subscription latches ``stalled`` on the detector's ``"stall"``
  notification and clears it on ``"recover"`` / ``"resume"``, so a wedged
  step fails requests in microseconds instead of letting them hang behind a
  dead queue.  Push, not poll.

**SLO classes**: every request carries a ``priority`` (``"high"`` /
``"normal"`` / ``"low"`` by default) and each class rides a fraction of the
queue bound (:data:`DEFAULT_CLASS_THRESHOLDS`): under pressure the low
class hits its smaller bound first.

Shutdown is two-phase: :meth:`begin_drain` sheds *new* work (``draining``)
while queued work finishes; :meth:`close` sheds everything (``closed``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..core import memtrack, telemetry

__all__ = ["AdmissionController", "DEFAULT_CLASS_THRESHOLDS", "RequestRejected"]

#: SLO classes and the fraction of ``max_queue_rows`` each may fill.
#: ``high`` and ``normal`` ride the full bound (so a fleet of one class
#: behaves exactly like the pre-SLO gate); ``low`` is shed once the
#: queue passes half — under pressure, low-priority work goes first.
DEFAULT_CLASS_THRESHOLDS = {"high": 1.0, "normal": 1.0, "low": 0.5}


class RequestRejected(RuntimeError):
    """The front door refused to queue a request (load shedding).

    This is the *documented* serving error: callers must catch it and
    back off rather than treat it as an infrastructure failure.  Fields:

    ``reason``
        One of ``"queue_full"``, ``"hbm_pressure"``, ``"stalled"``,
        ``"draining"``, ``"closed"``, ``"too_large"``.
    ``retry_after_s``
        Suggested client backoff in seconds, or ``None`` when retrying
        the same process cannot help (``closed``, ``too_large``).

    The message always reads ``serving request rejected (<reason>):
    <detail>`` with the retry hint appended when one exists, so log
    scrapers and tests can match on the reason token.
    """

    def __init__(self, reason: str, retry_after_s: Optional[float], detail: str):
        self.reason = str(reason)
        self.retry_after_s = retry_after_s
        msg = f"serving request rejected ({self.reason}): {detail}"
        if retry_after_s is not None:
            msg += f"; retry after {retry_after_s:g}s"
        super().__init__(msg)


class AdmissionController:
    """Bounded-queue + pressure-aware admission decisions.

    One controller fronts one :class:`~heat_tpu_torch.serving.engine.ServingEngine`;
    the engine calls :meth:`admit` before enqueueing and :meth:`release`
    when a request's rows leave the system (served or failed).  All state
    transitions are guarded by one lock; callbacks from the stall
    detector arrive on the watcher thread and only flip latches.
    """

    def __init__(
        self,
        *,
        max_queue_rows: int = 1024,
        retry_after_s: float = 0.05,
        memory_fraction: float = 0.5,
        memory_headroom: int = 0,
        class_thresholds: Optional[Dict[str, float]] = None,
    ):
        if max_queue_rows < 1:
            raise ValueError(f"max_queue_rows must be >= 1, got {max_queue_rows}")
        self.max_queue_rows = int(max_queue_rows)
        self.retry_after_s = float(retry_after_s)
        self.memory_fraction = float(memory_fraction)
        self.memory_headroom = int(memory_headroom)
        thresholds = dict(DEFAULT_CLASS_THRESHOLDS)
        if class_thresholds:
            thresholds.update(class_thresholds)
        for cls, fraction in thresholds.items():
            if not 0.0 < float(fraction) <= 1.0:
                raise ValueError(
                    f"class threshold for {cls!r} must be in (0, 1], got {fraction}"
                )
        self.class_thresholds = {c: float(f) for c, f in thresholds.items()}
        self._lock = threading.Lock()
        self._queued_rows = 0
        self._stalled = False
        self._draining = False
        self._closed = False
        self._detector = None

    # -- stall-detector subscription (push, not poll) -------------------

    def attach_stall_detector(self, detector) -> "AdmissionController":
        """Subscribe to ``detector`` so stall/pause/resume flip the
        ``stalled`` latch without any polling thread."""
        with self._lock:
            if self._detector is not None:
                raise RuntimeError("a StallDetector is already attached")
            self._detector = detector
        detector.subscribe(self._on_stall_event)
        return self

    def detach_stall_detector(self) -> None:
        with self._lock:
            detector, self._detector = self._detector, None
        if detector is not None:
            detector.unsubscribe(self._on_stall_event)

    def _on_stall_event(self, kind: str, info: Dict[str, Any]) -> None:
        # Watcher-thread context: latch flips only, no mesh work.
        if kind == "stall":
            with self._lock:
                self._stalled = True
            telemetry.record_event("serving_stall", **info)
        elif kind in ("recover", "resume"):
            with self._lock:
                self._stalled = False

    # -- lifecycle ------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting new work; queued work keeps flowing."""
        with self._lock:
            self._draining = True

    def close(self) -> None:
        """Terminal: everything is shed from here on."""
        with self._lock:
            self._draining = True
            self._closed = True
        self.detach_stall_detector()

    # -- the decision ---------------------------------------------------

    def admit(
        self, endpoint: str, rows: int, nbytes: int, *, priority: str = "normal"
    ) -> None:
        """Admit ``rows`` request rows (``nbytes`` of staging) for
        ``endpoint`` or raise :class:`RequestRejected`.

        ``priority`` selects the SLO class: the queue bound scales by
        the class's threshold, so under pressure classes below 1.0 shed
        first.  An unknown class is a programming error (``ValueError``),
        not load shedding."""
        rows = int(rows)
        threshold = self.class_thresholds.get(priority)
        if threshold is None:
            raise ValueError(
                f"unknown SLO class {priority!r}; known: {sorted(self.class_thresholds)}"
            )
        with self._lock:
            if self._closed:
                raise RequestRejected("closed", None, "serving engine is closed")
            if self._draining:
                raise RequestRejected(
                    "draining", self.retry_after_s, "engine is draining for shutdown"
                )
            if self._stalled:
                raise RequestRejected(
                    "stalled",
                    self.retry_after_s,
                    "mesh stall detected — failing fast instead of queueing behind it",
                )
            bound = int(self.max_queue_rows * threshold)
            if self._queued_rows + rows > bound:
                detail = (
                    f"{self._queued_rows} rows queued + {rows} requested "
                    f"> bound {bound}"
                )
                if threshold < 1.0:
                    detail += (
                        f" (class {priority!r} rides {threshold:g} of "
                        f"{self.max_queue_rows} — lower classes shed first)"
                    )
                raise RequestRejected("queue_full", self.retry_after_s, detail)
            fits = memtrack.would_fit(
                int(nbytes),
                fraction=self.memory_fraction,
                headroom=self.memory_headroom,
            )
            if fits is False:
                raise RequestRejected(
                    "hbm_pressure",
                    self.retry_after_s,
                    f"{int(nbytes)} staging bytes exceed the measured HBM budget",
                )
            self._queued_rows += rows

    def release(self, rows: int) -> None:
        """Rows left the system (served or failed) — free queue budget."""
        with self._lock:
            self._queued_rows = max(0, self._queued_rows - int(rows))

    def note_progress(self) -> None:
        """A batch completed on the mesh: any stale stall latch clears.

        Belt-and-braces next to the detector's ``"recover"`` push — an
        engine without an attached detector still self-heals."""
        with self._lock:
            self._stalled = False

    # -- introspection --------------------------------------------------

    @property
    def stalled(self) -> bool:
        with self._lock:
            return self._stalled

    @property
    def queued_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "queued_rows": self._queued_rows,
                "max_queue_rows": self.max_queue_rows,
                "stalled": self._stalled,
                "draining": self._draining,
                "closed": self._closed,
            }
