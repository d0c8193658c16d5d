"""Generated-style layers (ref: python/paddle/fluid/layers/ops.py); port
of the part of paddle_tpu/fluid/layers/ops.py that the GPT programs call.
The activation layers wait for the op library (ROADMAP.md Queue 1, item
6)."""
from .nn import _layer

__all__ = ["cumsum"]


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _layer(
        "cumsum",
        {"X": x},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
