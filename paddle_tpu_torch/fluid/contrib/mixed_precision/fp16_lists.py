"""ref import path contrib/mixed_precision/fp16_lists.py."""
from . import AutoMixedPrecisionLists, BLACK_LIST, WHITE_LIST  # noqa: F401

# the reference names the module-level sets this way
white_list = set(WHITE_LIST)
black_list = set(BLACK_LIST)
gray_list = set()  # ops that take their inputs' dtype, by jax's promotion

__all__ = ["AutoMixedPrecisionLists", "white_list", "black_list",
           "gray_list"]
