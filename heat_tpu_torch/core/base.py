"""Estimator base API (counterpart of heat_tpu/core/base.py):
scikit-learn-style parameter handling and the clustering and regression
mixins."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List

import torch

from .dndarray import DNDarray

__all__ = ["BaseEstimator", "ClusteringMixin", "RegressionMixin"]


class BaseEstimator:
    """Base for all estimators."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        """Parameters of this estimator."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params: Any):
        """Set parameters."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            head, _, tail = key.partition("__")
            if head not in valid:
                raise ValueError(f"invalid parameter {head} for estimator {self}")
            if tail:
                getattr(self, head).set_params(**{tail: value})
            else:
                setattr(self, head, value)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{self.__class__.__name__}({params})"


class ClusteringMixin:
    """fit/fit_predict for clusterers."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray) -> DNDarray:
        self.fit(x)
        return self.predict(x)


class RegressionMixin:
    """fit/predict/score for regressors (heat_tpu/core/base.py:105)."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()

    def score(self, x: DNDarray, y: DNDarray, sample_weight=None) -> float:
        """R² of the prediction (heat_tpu/core/base.py:118)."""
        pred = self.predict(x).larray.reshape(-1)
        yv = y.larray.reshape(-1).to(pred.device)
        ss_res = torch.sum((yv - pred) ** 2)
        ss_tot = torch.sum((yv - torch.mean(yv)) ** 2)
        return float(1.0 - ss_res / ss_tot)
