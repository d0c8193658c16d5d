"""slim.core (ref: contrib/slim/core). The port has ``strategy``;
``compressor`` and ``config`` (Compressor, Context, ConfigFactory) come
with the rest of slim (ROADMAP.md Queue 1, item 6.8)."""
from . import strategy  # noqa: F401
from .strategy import Strategy  # noqa: F401
from .. import _unported

__all__ = ["Strategy"]

__getattr__ = _unported(__name__, ("compressor", "Compressor", "Context",
                                   "cached_reader", "config",
                                   "ConfigFactory"))
