"""Helpers of the port: the synthetic batch the tests and chip_smoke.py
share, the opt-in NaN checks (``debug``) and the profiling hooks
(``profiling``)."""
from .synthetic import make_synthetic_batch

__all__ = ["make_synthetic_batch"]
