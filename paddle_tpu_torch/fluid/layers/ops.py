"""Generated-style layers (ref: python/paddle/fluid/layers/ops.py); port
of the part of paddle_tpu/fluid/layers/ops.py that the GPT programs and
Wide&Deep call, and ``abs``/``round``, which the int8-resident decode
step calls. The other activation layers wait for the op library
(ROADMAP.md Queue 1, item 6)."""
from .nn import _layer

__all__ = ["sigmoid", "abs", "round", "cumsum"]


def _make_unary(op_type):
    def layer(x, name=None):
        return _layer(op_type, {"X": x})

    layer.__name__ = op_type
    return layer


sigmoid = _make_unary("sigmoid")
abs = _make_unary("abs")
round = _make_unary("round")


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _layer(
        "cumsum",
        {"X": x},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
