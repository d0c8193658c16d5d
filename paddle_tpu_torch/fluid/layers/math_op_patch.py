"""Operator overloading on Variable (ref: python/paddle/fluid/layers/
math_op_patch.py); port of paddle_tpu/fluid/layers/math_op_patch.py,
which is jax-free. Installed once at fluid import: each operator appends
the op its layer appends (``scale`` for a scalar on the unreflected side,
else ``fill_constant([1])`` and the elementwise op)."""
from ..framework import Variable


def monkey_patch_variable():
    from . import nn, tensor

    def _scalar_op(var, scale, bias):
        return nn.scale(var, scale=scale, bias=bias)

    def _binary_creator(method_name, op, reverse=False, scalar_method=None):
        def __impl__(self, other):
            if isinstance(other, (int, float)):
                if scalar_method is not None and not reverse:
                    return scalar_method(self, other)
                other = tensor.fill_constant(
                    [1], self.dtype or "float32", float(other)
                )
            if reverse:
                x, y = other, self
            else:
                x, y = self, other
            return op(x, y)

        __impl__.__name__ = method_name
        return __impl__

    Variable.__add__ = _binary_creator(
        "__add__", nn.elementwise_add,
        scalar_method=lambda v, s: _scalar_op(v, 1.0, s),
    )
    Variable.__radd__ = _binary_creator(
        "__radd__", nn.elementwise_add, reverse=True
    )
    Variable.__sub__ = _binary_creator(
        "__sub__", nn.elementwise_sub,
        scalar_method=lambda v, s: _scalar_op(v, 1.0, -s),
    )
    Variable.__rsub__ = _binary_creator(
        "__rsub__", nn.elementwise_sub, reverse=True
    )
    Variable.__mul__ = _binary_creator(
        "__mul__", nn.elementwise_mul,
        scalar_method=lambda v, s: _scalar_op(v, s, 0.0),
    )
    Variable.__rmul__ = _binary_creator(
        "__rmul__", nn.elementwise_mul, reverse=True
    )
    Variable.__div__ = _binary_creator("__div__", nn.elementwise_div)
    Variable.__truediv__ = _binary_creator("__truediv__", nn.elementwise_div)
    Variable.__rdiv__ = _binary_creator(
        "__rdiv__", nn.elementwise_div, reverse=True
    )
    Variable.__rtruediv__ = Variable.__rdiv__
    Variable.__pow__ = _binary_creator("__pow__", nn.elementwise_pow)
    Variable.__rpow__ = _binary_creator(
        "__rpow__", nn.elementwise_pow, reverse=True
    )
    Variable.__floordiv__ = _binary_creator(
        "__floordiv__", nn.elementwise_floordiv
    )
    Variable.__mod__ = _binary_creator("__mod__", nn.elementwise_mod)
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)

    # NOTE: __eq__/__lt__/... are deliberately NOT overridden (matching the
    # reference's math_op_patch): overriding __eq__ breaks python equality,
    # `in` membership, and dict/set use of Variables, and would mutate the
    # program as a side effect. Use layers.equal/less_than/... instead.
