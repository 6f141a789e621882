"""Optimizer utilities (counterpart of heat_tpu/optim/utils.py)."""

from __future__ import annotations

from typing import Dict

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect when a metric has stopped improving (reference:
    optim/utils.py:14-160). State is checkpointable via
    ``get_state``/``set_state``, as the reference's DASO plateau detector is.

    Parameters
    ----------
    mode : str
        "min" (improvement = decrease) or "max".
    patience : int
        Epochs with no improvement before a plateau is declared.
    threshold : float
        Minimum relative/absolute change counting as improvement.
    threshold_mode : str
        "rel" or "abs".
    """

    def __init__(
        self,
        mode: str = "min",
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be 'rel' or 'abs', got {threshold_mode!r}")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.reset()

    def reset(self) -> None:
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.last_epoch = 0

    @property
    def in_cooldown(self) -> bool:
        """True while the post-plateau cooldown window is open (reference:
        utils.py — bad epochs are not counted during cooldown)."""
        return self.cooldown_counter > 0

    def get_state(self) -> Dict:
        """Checkpointable state (reference: utils.py:72)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "cooldown": self.cooldown,
            "cooldown_counter": self.cooldown_counter,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "last_epoch": self.last_epoch,
        }

    def set_state(self, dic: Dict) -> None:
        """Restore from ``get_state`` output (reference: utils.py:89)."""
        for key, value in dic.items():
            setattr(self, key, value)

    def is_better(self, a: float, best: float) -> bool:
        import math

        if not math.isfinite(best):
            # initial sentinel: anything beats ±inf (inf*threshold is nan)
            return True
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best - abs(best) * self.threshold
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best + abs(best) * self.threshold
        return a > best + self.threshold

    def test_if_improving(self, metrics: float) -> bool:
        """Feed a new value; True when the metric has plateaued (reference:
        utils.py:120 — the reference's parameter name is ``metrics``)."""
        current = float(metrics)
        self.last_epoch += 1
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        elif not self.in_cooldown:
            self.num_bad_epochs += 1
        if self.in_cooldown:
            # the window closes with every epoch, improving or not
            # (reference/torch ReduceLROnPlateau semantics)
            self.cooldown_counter -= 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
            return True
        return False
