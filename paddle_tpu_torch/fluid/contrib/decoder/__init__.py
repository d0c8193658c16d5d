"""contrib.decoder (ref: python/paddle/fluid/contrib/decoder)."""
from . import beam_search_decoder  # noqa: F401
from .beam_search_decoder import *  # noqa: F401,F403

__all__ = beam_search_decoder.__all__
