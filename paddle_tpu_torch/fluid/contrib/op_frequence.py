"""ref import path contrib/op_frequence.py; implementation in
utils_stat."""
from .utils_stat import op_freq_statistic  # noqa: F401

__all__ = ["op_freq_statistic"]
