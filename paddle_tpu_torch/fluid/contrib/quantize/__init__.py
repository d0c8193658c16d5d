"""contrib.quantize (ref: python/paddle/fluid/contrib/quantize)."""
from . import quantize_transpiler  # noqa: F401
from .quantize_transpiler import QuantizeTranspiler  # noqa: F401

__all__ = ["QuantizeTranspiler"]
