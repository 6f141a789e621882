"""Learning-rate schedules (counterpart of heat_tpu/optim/lr_scheduler.py):
functions of the update count with optax's values, usable as the ``lr`` of
the optimizers of :mod:`heat_tpu_torch.optim`."""

from __future__ import annotations

import math
from typing import Callable

__all__ = [
    "CosineAnnealingLR",
    "ExponentialLR",
    "StepLR",
    "constant_schedule",
    "cosine_decay_schedule",
    "exponential_decay",
]

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    """``optax.constant_schedule``."""
    return lambda count: value


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False, end_value=None) -> Schedule:
    """``optax.exponential_decay``: ``init · rate^(t / steps)`` past
    ``transition_begin``, the exponent floored with ``staircase``."""

    def schedule(count: int) -> float:
        t = max(count - transition_begin, 0)
        p = t / transition_steps
        if staircase:
            p = math.floor(p)
        v = init_value * decay_rate**p
        if end_value is not None:
            v = max(v, end_value) if decay_rate < 1 else min(v, end_value)
        return v

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def StepLR(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch's ``StepLR``: ``base · gamma^floor(t / step_size)``."""
    return exponential_decay(base_lr, step_size, gamma, staircase=True)


def ExponentialLR(base_lr: float, gamma: float) -> Schedule:
    """Per-step exponential decay: ``base · gamma^t``."""
    return exponential_decay(base_lr, 1, gamma)


def CosineAnnealingLR(base_lr: float, T_max: int, eta_min: float = 0.0) -> Schedule:
    """Cosine annealing to ``eta_min`` over ``T_max`` steps."""
    return cosine_decay_schedule(base_lr, T_max, alpha=eta_min / max(base_lr, 1e-30))
