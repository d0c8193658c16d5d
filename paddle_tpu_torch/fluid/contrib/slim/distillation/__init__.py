from .distiller import L2Distiller, SoftLabelDistiller  # noqa: F401
from . import distillation_strategy  # noqa: F401
from .distillation_strategy import DistillationStrategy  # noqa: F401

__all__ = ["L2Distiller", "SoftLabelDistiller", "DistillationStrategy"]
