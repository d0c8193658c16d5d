"""layers.layer_function_generator (ref: fluid/layers/
layer_function_generator.py — generates layer functions + docs from
the C++ op protos).

Here ops have no protobuf protos; the generator builds layer functions
over the op lowering registry instead (a copy of paddle_tpu/fluid/layers/
layer_function_generator.py over the port's registry): ``generate_layer_fn(op_type)``
returns a function appending that op with the conventional X/Y->Out
slots (exactly what the reference's generated activations do), and the
doc decorators are functional (they format the docstring templates the
reference's layers use).
"""
import re

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "generate_layer_fn", "generate_activation_fn", "autodoc",
    "templatedoc", "add_sample_code",
]


def _check_registered(op_type):
    from ...ops.registry import LOWERINGS

    if op_type not in LOWERINGS:
        raise ValueError(
            "op %r has no registered lowering; cannot generate a layer "
            "function for it" % op_type)


def generate_layer_fn(op_type):
    """A layer function for a conventional (X[, Y]) -> Out op
    (ref layer_function_generator.py:87)."""
    _check_registered(op_type)

    def func(*args, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        inputs = {}
        vars_in = list(args) + [
            kwargs[k] for k in ("x", "y", "input") if k in kwargs
        ]
        slots = ["X", "Y", "Z"]
        for slot, v in zip(slots, vars_in):
            inputs[slot] = [v]
        out = helper.create_variable_for_type_inference(
            vars_in[0].dtype if vars_in else "float32")
        if vars_in and isinstance(vars_in[0], Variable) and \
                vars_in[0].shape is not None:
            out.shape = vars_in[0].shape
        attrs = {k: v for k, v in kwargs.items()
                 if k not in ("x", "y", "input", "name")
                 and not isinstance(v, Variable)}
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    func.__name__ = op_type
    func.__doc__ = "Generated layer for the %r lowering." % op_type
    return func


def generate_activation_fn(op_type):
    """A unary activation layer (ref :190)."""
    _check_registered(op_type)

    def func(x, name=None):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(x.dtype)
        if x.shape is not None:
            out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    func.__name__ = op_type
    func.__doc__ = "%s activation (generated)." % op_type
    return func


def autodoc(comment=""):
    """Docstring decorator (ref :250): prepends ``comment``."""

    def __impl__(func):
        func.__doc__ = comment + (func.__doc__ or "")
        return func

    return __impl__


def templatedoc(op_type=None):
    """Fill ``${comment}``-style slots in a docstring (ref :264). The
    per-op C++ comments do not exist here; slots resolve to the op
    type name so the docs stay readable."""

    def __impl__(func):
        doc = func.__doc__ or ""
        name = op_type or func.__name__
        doc = re.sub(r"\$\{comment\}", "the %s op" % name, doc)
        doc = re.sub(r"\$\{(\w+)_comment\}", r"\1", doc)
        doc = re.sub(r"\$\{(\w+)_type\}", r"\1", doc)
        func.__doc__ = doc
        return func

    return __impl__


def add_sample_code(func, sample_code):
    """Append an Examples section (ref :330)."""
    func.__doc__ = (func.__doc__ or "") + sample_code
