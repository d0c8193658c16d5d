"""contrib.reader (ref: python/paddle/fluid/contrib/reader)."""
from . import distributed_reader  # noqa: F401
from .distributed_reader import *  # noqa: F401,F403

__all__ = list(distributed_reader.__all__)
