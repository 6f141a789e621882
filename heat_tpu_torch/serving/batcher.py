"""Dynamic batcher: coalesce in-flight requests into bucketed batches
(counterpart of heat_tpu/serving/batcher.py).

One daemon worker drains per-endpoint FIFO queues.  A queue flushes when
one of three causes fires, and the cause is reported to the executor so
the telemetry plane can count *why* batches formed:

``"max_batch"``
    Enough rows are queued to fill the endpoint's largest bucket: flush
    at once, the latency timer not consulted.
``"timer"``
    The oldest queued request hit its ``max_delay_s`` deadline: ship a
    partial batch rather than hold a caller hostage for stragglers.
``"drain"``
    Shutdown: everything queued is flushed regardless of deadlines.

The batcher never splits a request across batches (the engine's
per-request unpadding stays a contiguous row slice), and it knows nothing
of shapes, buckets or devices: it moves :class:`Request` objects and calls
``execute(endpoint, requests, cause)`` outside its lock, so a slow step
never blocks enqueues.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["DynamicBatcher", "Request"]


@dataclass
class Request:
    """One admitted request riding the queue.

    ``payload`` is the host-side (rows, feature_dim) array, ``deadline``
    the absolute ``time.perf_counter()`` instant after which the flush
    timer fires, ``t0`` the submit instant for the latency histogram.
    ``priority`` is the SLO class the admission gate admitted under;
    ``client_deadline`` (absolute, or ``None``) is the *caller's*
    deadline — a request still queued when it lapses is shed at flush
    (``expired``) instead of computing an answer nobody is waiting for."""

    endpoint: str
    payload: Any
    rows: int
    t0: float
    deadline: float
    priority: str = "normal"
    client_deadline: Optional[float] = None
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Condition-variable driven coalescing queue (one worker thread).

    ``execute`` is called as ``execute(endpoint, requests, cause)`` with
    the batcher lock **released**; it owns resolving every request's
    future (success or failure) — the batcher never touches futures of
    work it has handed off."""

    def __init__(
        self,
        execute: Callable[[str, Sequence[Request], str], None],
        *,
        name: str = "heat-tpu-torch-serving-batcher",
    ):
        self._execute = execute
        self._name = name
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[Request]] = {}
        self._caps: Dict[str, int] = {}
        self._in_flight = 0
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    # -- producer side --------------------------------------------------

    def enqueue(self, request: Request, max_batch_rows: int) -> None:
        """Queue an admitted request; starts the worker lazily."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self._caps[request.endpoint] = int(max_batch_rows)
            self._queues.setdefault(request.endpoint, deque()).append(request)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name=self._name, daemon=True
                )
                self._thread.start()
            self._cond.notify_all()

    # -- worker side ----------------------------------------------------

    def _pick_locked(
        self, now: float
    ) -> Tuple[Optional[Tuple[str, List[Request], str]], Optional[float]]:
        """Under the lock: choose the most urgent flushable queue.

        Returns ``((endpoint, requests, cause), None)`` when a flush is
        due, else ``(None, seconds_until_next_deadline_or_None)``."""
        best: Optional[Tuple[float, str, str]] = None
        wait: Optional[float] = None
        for name, queue in self._queues.items():
            if not queue:
                continue
            head = queue[0]
            rows = sum(r.rows for r in queue)
            if rows >= self._caps.get(name, 1):
                cause = "max_batch"
            elif self._draining or self._stopped:
                cause = "drain"
            elif now >= head.deadline:
                cause = "timer"
            else:
                until = head.deadline - now
                wait = until if wait is None else min(wait, until)
                continue
            if best is None or head.deadline < best[0]:
                best = (head.deadline, name, cause)
        if best is None:
            return None, wait
        _, name, cause = best
        queue = self._queues[name]
        cap = self._caps.get(name, 1)
        picked: List[Request] = [queue.popleft()]
        total = picked[0].rows
        while queue and total + queue[0].rows <= cap:
            req = queue.popleft()
            picked.append(req)
            total += req.rows
        return (name, picked, cause), None

    def _worker(self) -> None:
        while True:
            with self._cond:
                while True:
                    picked, wait = self._pick_locked(time.perf_counter())
                    if picked is not None:
                        self._in_flight += 1
                        break
                    if self._stopped:
                        return
                    self._cond.wait(timeout=wait)
            name, requests, cause = picked
            try:
                self._execute(name, requests, cause)
            finally:
                with self._cond:
                    self._in_flight -= 1
                    self._cond.notify_all()

    # -- lifecycle ------------------------------------------------------

    def pending_requests(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def busy(self) -> int:
        """Queued requests plus in-flight batches.  Zero means the worker
        is legitimately idle (no heartbeats expected); nonzero while a
        stall detector fires means work is actually wedged — the fleet
        router uses this to tell a quiet replica from a dead one."""
        with self._cond:
            return sum(len(q) for q in self._queues.values()) + self._in_flight

    def in_flight(self) -> int:
        """Batches currently executing.  Queued-but-unflushed requests
        don't count: a queue waiting out ``max_delay_s`` is batching
        latency, not a wedged step, and must not trip the breaker."""
        with self._cond:
            return self._in_flight

    def drain(self, timeout: float = 30.0) -> bool:
        """Flush every queue (cause ``"drain"``) and wait for in-flight
        batches to land.  True when fully drained inside ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while any(self._queues.values()) or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def cancel_pending(self) -> List[Request]:
        """Pop everything still queued (caller owns the futures)."""
        with self._cond:
            out: List[Request] = []
            for queue in self._queues.values():
                out.extend(queue)
                queue.clear()
            self._cond.notify_all()
            return out

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the worker; queued work should be drained or cancelled
        first — anything left flushes with cause ``"drain"`` on the way
        out."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
