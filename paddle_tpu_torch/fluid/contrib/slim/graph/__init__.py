"""slim.graph (ref: python/paddle/fluid/contrib/slim/graph). Port of
paddle_tpu/fluid/contrib/slim/graph."""
from . import graph_wrapper  # noqa: F401
from .graph_wrapper import GraphWrapper, OpWrapper, VarWrapper  # noqa: F401

__all__ = ["GraphWrapper", "OpWrapper", "VarWrapper"]
