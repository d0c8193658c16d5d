"""ref import path contrib/extend_optimizer/
extend_optimizer_with_weight_decay.py — implementation in the package
__init__."""
from . import extend_with_decoupled_weight_decay  # noqa: F401

__all__ = ["extend_with_decoupled_weight_decay"]
