"""Naive Bayes estimators (counterpart of heat_tpu/naive_bayes/)."""

from .gaussianNB import GaussianNB, gaussiannb_from_state

__all__ = ["GaussianNB", "gaussiannb_from_state"]
