"""Comparison layers (ref: python/paddle/fluid/layers/control_flow.py);
port of the comparisons of paddle_tpu/fluid/layers/control_flow.py that
the GPT decode programs call. ``While``, ``cond``, ``IfElse`` and the rest
of the control-flow layers wait for the control-flow slice (ROADMAP.md
Queue 1, item 6.2)."""
from ..layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "equal"]


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, x=x, y=y)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
    cond.shape = x.shape
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [cond]},
    )
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)
