"""ref import path contrib/mixed_precision/decorator.py — the
implementation lives in the package __init__."""
from . import decorate, OptimizerWithMixedPrecision  # noqa: F401

__all__ = ["decorate", "OptimizerWithMixedPrecision"]
