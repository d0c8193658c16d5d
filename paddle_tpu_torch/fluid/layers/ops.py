"""Generated-style layers (ref: python/paddle/fluid/layers/ops.py); port
of paddle_tpu/fluid/layers/ops.py: the unary math and activation layers,
``cumsum``, ``uniform_random`` and the ``gelu`` re-export."""
from .. import core
from ..layer_helper import LayerHelper
from .nn import _layer

__all__ = [
    "sigmoid", "logsigmoid", "exp", "tanh", "atan", "sqrt", "rsqrt", "abs",
    "ceil", "floor", "cos", "acos", "asin", "sin", "sinh", "cosh", "round",
    "reciprocal", "square", "softplus", "softsign", "softshrink",
    "hard_shrink", "tanh_shrink", "cumsum", "thresholded_relu",
    "uniform_random", "erf", "tan",
]


def _make_unary(op_type):
    def layer(x, name=None):
        return _layer(op_type, {"X": x})

    layer.__name__ = op_type
    return layer


sigmoid = _make_unary("sigmoid")
logsigmoid = _make_unary("logsigmoid")
exp = _make_unary("exp")
tanh = _make_unary("tanh")
atan = _make_unary("atan")
sqrt = _make_unary("sqrt")
rsqrt = _make_unary("rsqrt")
abs = _make_unary("abs")
ceil = _make_unary("ceil")
floor = _make_unary("floor")
cos = _make_unary("cos")
acos = _make_unary("acos")
asin = _make_unary("asin")
sin = _make_unary("sin")
sinh = _make_unary("sinh")
cosh = _make_unary("cosh")
round = _make_unary("round")
reciprocal = _make_unary("reciprocal")
square = _make_unary("square")
softplus = _make_unary("softplus")
softsign = _make_unary("softsign")
erf = _make_unary("erf")
tan = _make_unary("tan")
tanh_shrink = _make_unary("tanh_shrink")


def softshrink(x, alpha=0.5):
    return _layer("softshrink", {"X": x}, {"lambda": alpha})


def hard_shrink(x, threshold=0.5):
    return _layer("hard_shrink", {"X": x}, {"threshold": threshold})


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _layer(
        "cumsum",
        {"X": x},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )


def thresholded_relu(x, threshold=1.0):
    return _layer("thresholded_relu", {"X": x}, {"threshold": threshold})


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random", shape=shape)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "min": min,
            "max": max,
            "seed": seed,
            "dtype": core.convert_dtype(dtype),
        },
    )
    return out


# ref ops.py:243 re-exports gelu through the generated-layer path; the
# implementation lives in nn.py here — resolved lazily (PEP 562) to keep
# the nn<->ops import acyclic at module-exec time
__all__ += ["gelu"]


def __getattr__(name):
    if name == "gelu":
        from .nn import gelu

        return gelu
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
