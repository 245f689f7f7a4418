"""Helpers of the port that the tests and chip_smoke.py share."""
from .synthetic import make_synthetic_batch

__all__ = ["make_synthetic_batch"]
