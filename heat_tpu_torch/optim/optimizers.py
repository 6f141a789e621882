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
* :class:`Adadelta` — ``optax.adadelta``: ``g + wd·p``, then
  ``sqrt(E[Δ²] + eps) / sqrt(E[g²] + eps) · g`` with rho 0.9 and eps 1e-6,
  then ``-lr``; ``lr=None`` (optax's default) scales by nothing, so the
  update is not negated either.
* :class:`Lamb` — ``optax.lamb``: Adam's direction with eps 1e-6, plus
  ``weight_decay · p``, times the trust ratio ``‖p‖ / ‖u‖`` (1 where a
  norm is 0), then ``-lr``.
* :class:`Lars` — ``optax.lars``: ``g + wd·p``, times the trust ratio
  ``0.001 · ‖p‖ / (‖u‖ + eps)`` (1 where a norm is 0), then ``-lr``, then
  a ``trace`` momentum of 0.9.

``lr`` may be a schedule (a callable of the update count, as optax's
``ScalarOrSchedule``), read at the count before the update.  Norms are
over each parameter tensor, as optax's are over each leaf.  The masks of
``lamb``/``lars`` take a bool (every parameter or none).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Lamb", "Lars", "RMSprop", "Sgd"]

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

    def _lr(self, group) -> Optional[float]:
        lr = group["lr"]
        if lr is None:
            return None
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
                u = self._direction(p, p.grad, state, group)
                p.add_(self._after_lr(u if lr is None else u * -lr, state, group))
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


def _trust_ratio(p: torch.Tensor, u: torch.Tensor, coefficient: float, eps: float) -> torch.Tensor:
    """``optax.scale_by_trust_ratio``'s factor: ``coefficient·‖p‖ / (‖u‖ +
    eps)``, 1 where either norm is 0."""
    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * p_norm / (u_norm + eps)
    zero = torch.logical_or(p_norm == 0.0, u_norm == 0.0)
    return torch.where(zero, torch.ones((), dtype=p.dtype, device=p.device), ratio)


def _mask(mask, name: str) -> bool:
    if mask is None or isinstance(mask, bool):
        return mask is not False
    raise TypeError(f"{name} takes a bool in the port (a tree of masks is not supported), got {type(mask).__name__}")


class Adadelta(_Optax):
    """``optax.adadelta(learning_rate=None, rho=0.9, eps=1e-6, weight_decay=0.0)``."""

    def __init__(self, params, lr: Optional[Schedule] = None, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0, weight_decay_mask=None):
        super().__init__(params, lr, rho=rho, eps=eps, weight_decay=weight_decay,
                         weight_decay_mask=_mask(weight_decay_mask, "weight_decay_mask"))

    def _direction(self, p, g, state, group):
        rho, eps = group["rho"], group["eps"]
        if group["weight_decay"] and group["weight_decay_mask"]:
            g = g + group["weight_decay"] * p
        e_g = (1 - rho) * (g * g) + rho * state.get("e_g", torch.zeros_like(g))
        u = torch.sqrt(state.get("e_x", torch.zeros_like(g)) + eps) / torch.sqrt(e_g + eps) * g
        state["e_x"] = (1 - rho) * (u * u) + rho * state.get("e_x", torch.zeros_like(g))
        state["e_g"] = e_g
        return u


class Lamb(Adam):
    """``optax.lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
    weight_decay=0.0)``."""

    def __init__(self, params, lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0, mask=None):
        super().__init__(params, lr, b1, b2, eps, eps_root, weight_decay if _mask(mask, "mask") else 0.0)

    def _direction(self, p, g, state, group):
        u = super()._direction(p, g, state, group)
        return u * _trust_ratio(p, u, 1.0, 0.0)


class Lars(_Optax):
    """``optax.lars(learning_rate, weight_decay=0.0, weight_decay_mask=True,
    trust_coefficient=0.001, eps=0.0, trust_ratio_mask=True, momentum=0.9,
    nesterov=False)``."""

    def __init__(self, params, lr: Schedule = 1e-3, weight_decay: float = 0.0, weight_decay_mask=True,
                 trust_coefficient: float = 0.001, eps: float = 0.0, trust_ratio_mask=True, momentum: float = 0.9,
                 nesterov: bool = False):
        super().__init__(params, lr, weight_decay=weight_decay,
                         weight_decay_mask=_mask(weight_decay_mask, "weight_decay_mask"),
                         trust_coefficient=trust_coefficient, eps=eps,
                         trust_ratio_mask=_mask(trust_ratio_mask, "trust_ratio_mask"), momentum=momentum,
                         nesterov=nesterov)

    def _direction(self, p, g, state, group):
        if group["weight_decay"] and group["weight_decay_mask"]:
            g = g + group["weight_decay"] * p
        if group["trust_ratio_mask"]:
            g = g * _trust_ratio(p, g, group["trust_coefficient"], group["eps"])
        return g

    def _after_lr(self, u, state, group):
        return _trace(state, u, group["momentum"], group["nesterov"])
