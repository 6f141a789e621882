"""optax's optimizers as ``torch.optim.Optimizer``\\ s (the lowercase names
of heat_tpu/optim/__init__.py:13-22 fall through to optax there).

Each class computes optax's update with optax's defaults, which are not
``torch.optim``'s where the two differ:

* :class:`Sgd` — ``optax.sgd``: ``trace`` momentum (``m = g + μ·m``,
  Nesterov ``g + μ·m``), then ``-lr``.
* :class:`Adam` — ``optax.adam``: moments ``(1−b)·g + b·m``, bias
  corrections ``1 − b^t``, ``m̂ / (sqrt(v̂ + eps_root) + eps)``.
* :class:`AdamW` — ``optax.adamw``: Adam's update plus
  ``weight_decay · p`` (default 1e-4; torch's ``AdamW`` has 1e-2), then
  ``-lr``.
* :class:`RMSprop` — ``optax.rmsprop``: decay 0.9, eps inside the square
  root (``g · rsqrt(v + eps)``), accumulator from ``initial_scale`` 0,
  then ``-lr``, then an optional ``trace`` momentum.
* :class:`Adagrad` — ``optax.adagrad``: accumulator from 0.1,
  ``g · rsqrt(s + eps)`` with eps 1e-7, then ``-lr``.

``lr`` may be a schedule (a callable of the update count, as optax's
``ScalarOrSchedule``), read at the count before the update.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["Adagrad", "Adam", "AdamW", "RMSprop", "Sgd"]

Schedule = Union[float, Callable[[int], float]]


class _Optax(torch.optim.Optimizer):
    """Common part: per-parameter state, the update count and the
    learning rate read from a schedule."""

    def __init__(self, params, lr: Schedule, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))
        self.count = 0

    def state_dict(self):
        """torch's state dict with the update count."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)

    def _lr(self, group) -> float:
        lr = group["lr"]
        return float(lr(self.count)) if callable(lr) else float(lr)

    def _direction(self, p: torch.Tensor, g: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
        raise NotImplementedError

    def _after_lr(self, u: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
        """The transforms that follow the learning rate in optax's chain."""
        return u

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = self._lr(group)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                p.add_(self._after_lr(self._direction(p, p.grad, state, group) * -lr, state, group))
        self.count += 1
        return loss


def _trace(state: dict, u: torch.Tensor, decay: float, nesterov: bool) -> torch.Tensor:
    """``optax.trace``: ``t = u + decay·t`` (from zeros); Nesterov ``u + decay·t``."""
    t = state.get("trace")
    t = u.clone() if t is None else u + decay * t
    state["trace"] = t
    return u + decay * t if nesterov else t


class Sgd(_Optax):
    """``optax.sgd(learning_rate, momentum=None, nesterov=False)``."""

    def __init__(self, params, lr: Schedule = 1e-3, momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def _direction(self, p, g, state, group):
        if group["momentum"] is None:
            return g
        return _trace(state, g, group["momentum"], group["nesterov"])


class Adam(_Optax):
    """``optax.adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)``."""

    def __init__(self, params, lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)

    def _direction(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        mu = (1 - b1) * g + b1 * state.get("mu", torch.zeros_like(g))
        nu = (1 - b2) * (g * g) + b2 * state.get("nu", torch.zeros_like(g))
        state["mu"], state["nu"] = mu, nu
        t = self.count + 1
        mu_hat = mu / (1 - b1**t)
        nu_hat = nu / (1 - b2**t)
        u = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        return u + group["weight_decay"] * p if group["weight_decay"] else u


class AdamW(Adam):
    """``optax.adamw(learning_rate, ..., weight_decay=1e-4)``: Adam's update
    plus ``weight_decay · p``."""

    def __init__(self, params, lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 1e-4):
        super().__init__(params, lr, b1, b2, eps, eps_root, weight_decay)


class RMSprop(_Optax):
    """``optax.rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0,
    eps_in_sqrt=True, centered=False, momentum=None, nesterov=False)``."""

    def __init__(self, params, lr: Schedule = 1e-3, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, lr, decay=decay, eps=eps, initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
                         centered=centered, momentum=momentum, nesterov=nesterov)

    def _direction(self, p, g, state, group):
        d, eps = group["decay"], group["eps"]
        nu = (1 - d) * (g * g) + d * state.get("nu", torch.full_like(g, group["initial_scale"]))
        state["nu"] = nu
        if group["centered"]:
            mu = (1 - d) * g + d * state.get("mu", torch.zeros_like(g))
            state["mu"] = mu
            nu = nu - mu * mu
        scale = torch.rsqrt(nu + eps) if group["eps_in_sqrt"] else 1 / (torch.sqrt(nu) + eps)
        return scale * g

    def _after_lr(self, u, state, group):
        # optax.rmsprop's momentum trace follows the learning rate
        if group["momentum"] is None:
            return u
        return _trace(state, u, group["momentum"], group["nesterov"])


class Adagrad(_Optax):
    """``optax.adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7)``."""

    def __init__(self, params, lr: Schedule = 1e-3, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, lr, initial_accumulator_value=initial_accumulator_value, eps=eps)

    def _direction(self, p, g, state, group):
        s = g * g + state.get("sum_of_squares", torch.full_like(g, group["initial_accumulator_value"]))
        state["sum_of_squares"] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros((), dtype=s.dtype, device=s.device))
        return inv * g
