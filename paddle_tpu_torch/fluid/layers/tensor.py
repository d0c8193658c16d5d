"""Tensor creation layers (ref: python/paddle/fluid/layers/tensor.py);
port of paddle_tpu/fluid/layers/tensor.py, the part BERT and the
mixed-precision decorator call."""
from .. import core
from .. import unique_name
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "cast", "fill_constant"]


def create_parameter(
    shape,
    dtype,
    name=None,
    attr=None,
    is_bias=False,
    default_initializer=None,
):
    helper = LayerHelper("create_parameter", **locals())
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(
        attr, shape, dtype, is_bias, default_initializer
    )


def create_global_var(
    shape, value, dtype, persistable=False, force_cpu=False, name=None
):
    """A global var set to `value` by a startup ``fill_constant``; a
    non-persistable one is also filled in the main program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype,
        shape=shape,
        persistable=persistable,
        name=name or unique_name.generate("global_var"),
    )
    helper.set_variable_initializer(var, Constant(value))
    if not persistable:
        helper.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "value": float(value)},
        )
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": core.convert_dtype(dtype)},
    )
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": core.convert_dtype(dtype),
            "value": float(value),
            "force_cpu": force_cpu,
        },
    )
    out.stop_gradient = True
    return out
