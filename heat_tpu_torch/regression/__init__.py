"""Regression estimators."""

from .convert import lasso_from_state
from .lasso import Lasso

__all__ = ["Lasso", "lasso_from_state"]
