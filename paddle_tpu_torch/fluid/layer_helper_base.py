"""ref import path python/paddle/fluid/layer_helper_base.py; the helper
hierarchy is flattened into fluid/layer_helper.py here (one class covers
both roles — weight-norm reparam included)."""
from .layer_helper import LayerHelper as LayerHelperBase  # noqa: F401

__all__ = ["LayerHelperBase"]
