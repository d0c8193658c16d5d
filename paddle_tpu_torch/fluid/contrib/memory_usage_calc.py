"""ref import path contrib/memory_usage_calc.py; implementation in
utils_stat (a device-memory estimate)."""
from .utils_stat import memory_usage  # noqa: F401

__all__ = ["memory_usage"]
