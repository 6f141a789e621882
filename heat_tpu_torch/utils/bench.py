"""Chain-delta timing (counterpart of heat_tpu/utils/bench.py).

A derived rate is a chain-delta slope, not one timed call: time k1 units,
time k2 units, divide the difference, so any fixed cost (a readback, the
launch overhead, an estimator's readbacks) appears in both timings and
cancels.  k2 is found by doubling the chain until the delta dwarfs the
noise floor.  Before each reading the clock waits for the card, so a
reading covers the work its chain queued.
"""

from __future__ import annotations

import time
import typing

import torch

__all__ = ["Slope", "chain_slope"]


class Slope(typing.NamedTuple):
    per_unit_s: float
    k1: int
    k2: int
    trials: int
    capped: bool  # the doubling hit max_k before the delta reached its target

    def fields(self):
        """Self-describing record fields for ``monitor.record``."""
        d = {"method": "chain-delta", "k1": self.k1, "k2": self.k2, "trials": self.trials}
        if self.capped:
            # the delta stayed inside the noise floor: flag it so nobody
            # reads the number as authoritative
            d["delta_below_min"] = True
        return d


def _wait_for_card() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # ht: HT002 ok — the timing barrier: each reading covers the work its chain queued


def chain_slope(run_k, k1: int = 1, min_delta: float = 0.25, trials: int = 3, max_k: int = 1025) -> Slope:
    """Median per-unit seconds via chain deltas.

    ``run_k(k)`` must execute ``k`` units of identical work; the caller has
    warmed it up (kernels built, caches filled) beforehand.
    """

    def timed(k):
        _wait_for_card()
        t0 = time.perf_counter()
        run_k(k)
        _wait_for_card()
        return time.perf_counter() - t0

    t1 = timed(k1)
    # for expensive units the fixed floor is not enough: scale the target
    # with the first (overhead-inflated, so conservative) probe, capped so
    # one trial stays bounded
    target = max(min_delta, min(4.0 * t1, 8.0))
    dk = 1
    while True:
        t2 = timed(k1 + dk)
        if t2 - t1 >= target or k1 + dk >= max_k:
            break
        dk *= 2
    k2 = k1 + dk
    slopes = [(t2 - t1) / dk]
    for _ in range(trials - 1):
        a, b = timed(k1), timed(k2)
        slopes.append((b - a) / dk)
    slopes.sort()
    return Slope(slopes[len(slopes) // 2], k1, k2, trials, t2 - t1 < target)
