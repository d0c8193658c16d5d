"""slim.core (ref: contrib/slim/core). Port of
paddle_tpu/fluid/contrib/slim/core."""
from . import strategy  # noqa: F401
from .strategy import Strategy  # noqa: F401
from . import compressor  # noqa: F401
from .compressor import Compressor, Context, cached_reader  # noqa: F401
from . import config  # noqa: F401
from .config import ConfigFactory  # noqa: F401

__all__ = ["Strategy", "Compressor", "Context", "ConfigFactory"]
