"""ref import path contrib/model_stat.py; implementation in
utils_stat (per-layer params/FLOPs table)."""
from .utils_stat import summary  # noqa: F401

__all__ = ["summary"]
