"""Tensor creation layers (ref: python/paddle/fluid/layers/tensor.py);
port of paddle_tpu/fluid/layers/tensor.py, the part BERT, GPT, the
mixed-precision decorator and the decoders of the NMT slice call."""
import numpy as np

from .. import core
from .. import unique_name
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "cast", "concat",
           "assign", "fill_constant", "fill_constant_batch_size_like",
           "argmax", "range", "zeros_like"]


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype()
    )
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        ref = list(shapes[0])
        ax = axis if axis >= 0 else axis + len(ref)
        total = 0
        for s in shapes:
            total += s[ax] if s[ax] is not None else 0
        ref[ax] = total if all(s[ax] not in (None, -1) for s in shapes) else -1
        out.shape = tuple(ref)
    helper.append_op(
        type="concat",
        inputs={"X": input},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def assign(input, output=None):
    """Copy a Variable (the ``assign`` op), or a numpy array, list or
    number into a new one (``assign_value``: the values travel in the
    op's attrs)."""
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype
            )
            output.shape = input.shape
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    elif isinstance(input, (np.ndarray, list, tuple, float, int)):
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=core.convert_dtype(arr.dtype)
            )
            output.shape = arr.shape
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "dtype": core.convert_dtype(arr.dtype),
                "shape": list(arr.shape),
                "values": arr.reshape(-1).tolist(),
            },
        )
    else:
        raise TypeError("assign: unsupported input %r" % (input,))
    return output


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


def fill_constant_batch_size_like(
    input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0,
    force_cpu=False
):
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = tuple(shape[:output_dim_idx] + [-1] + shape[output_dim_idx + 1:]) \
        if input.shape is None else tuple(shape)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": core.convert_dtype(dtype),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", x=x, axis=axis)
    out = helper.create_variable_for_type_inference("int64")
    if x.shape is not None:
        s = list(x.shape)
        ax = axis if axis >= 0 else axis + len(s)
        s.pop(ax)
        out.shape = tuple(s)
    helper.append_op(
        type="arg_max",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def range(start, end, step, dtype):
    helper = LayerHelper("range", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    try:
        n = int(np.ceil((float(end) - float(start)) / float(step)))
        out.shape = (n,)
    except (TypeError, ValueError):
        out.shape = (-1,)
    inputs = {}
    attrs = {"dtype": core.convert_dtype(dtype)}
    for key, val in (("Start", start), ("End", end), ("Step", step)):
        if isinstance(val, Variable):
            inputs[key] = [val]
        else:
            attrs[key.lower()] = float(val)
    helper.append_op(
        type="range", inputs=inputs, outputs={"Out": [out]}, attrs=attrs
    )
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]}
    )
    return out
