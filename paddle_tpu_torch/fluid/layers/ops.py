"""Generated-style layers (ref: python/paddle/fluid/layers/ops.py); port
of the part of paddle_tpu/fluid/layers/ops.py that the GPT programs,
Wide&Deep and the learning-rate schedules call, and ``abs``/``round``,
which the int8-resident decode step calls, and ``tanh``, which the
recurrent cells and the recurrent book chapters call. The other
activation layers wait for the op library (ROADMAP.md Queue 1, item 6)."""
from .nn import _layer

__all__ = ["sigmoid", "tanh", "exp", "sqrt", "abs", "ceil", "floor", "cos",
           "round", "square", "cumsum"]


def _make_unary(op_type):
    def layer(x, name=None):
        return _layer(op_type, {"X": x})

    layer.__name__ = op_type
    return layer


sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")
exp = _make_unary("exp")
sqrt = _make_unary("sqrt")
abs = _make_unary("abs")
ceil = _make_unary("ceil")
floor = _make_unary("floor")
cos = _make_unary("cos")
round = _make_unary("round")
square = _make_unary("square")


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _layer(
        "cumsum",
        {"X": x},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
