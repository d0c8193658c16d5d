"""Tensor creation layers (ref: python/paddle/fluid/layers/tensor.py);
port of paddle_tpu/fluid/layers/tensor.py."""
import numpy as np

from .. import core
from .. import unique_name
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "cast", "concat",
           "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "argmax", "argsort", "range",
           "zeros_like", "reverse", "create_tensor",
           "tensor_array_to_tensor", "argmin", "ones", "zeros", "has_inf",
           "has_nan", "isfinite", "linspace", "ones_like", "diag", "eye"]


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


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
        out.shape = input[0].shape
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
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


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    out.shape = input.shape
    ids.shape = input.shape
    helper.append_op(
        type="argsort",
        inputs={"X": [input]},
        outputs={"Out": [out], "Indices": [ids]},
        attrs={"axis": axis, "descending": descending},
    )
    return out, ids


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


def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    helper = LayerHelper("reverse", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="reverse",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(
        name=helper.name, dtype=dtype, persistable=persistable
    )


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """Concat/stack a LoDTensorArray into one tensor (ref tensor.py
    tensor_array_to_tensor). Arrays here are build-time entry lists (see
    control_flow.create_array), so this composes concat/stack directly;
    also returns the per-entry sizes along axis like the reference."""
    import numpy as np

    from .nn import stack as _stack

    entries = [v for v in getattr(input, "vars", input) if v is not None]
    if not entries:
        raise ValueError("tensor_array_to_tensor: the array is empty")
    if use_stack:
        out = _stack(entries, axis=axis)
        sizes = [1] * len(entries)
    else:
        out = concat(entries, axis=axis)
        sizes = [
            (v.shape[axis] if v.shape is not None else -1) for v in entries
        ]
    out_index = assign(np.asarray(sizes, dtype="int32"))
    return out, out_index


def _arg_min_max(op_type, x, axis=0):
    helper = LayerHelper(op_type, x=x, axis=axis)
    out = helper.create_variable_for_type_inference("int64")
    if x.shape is not None:
        s = list(x.shape)
        ax = axis if axis >= 0 else axis + len(s)
        s.pop(ax)
        out.shape = tuple(s)
    helper.append_op(
        type=op_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def argmin(x, axis=0):
    return _arg_min_max("arg_min", x, axis)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def _unary_bool(op_type, x, reduce_to_scalar=True):
    helper = LayerHelper(op_type, x=x)
    out = helper.create_variable_for_type_inference("bool")
    out.shape = ()
    helper.append_op(
        type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}
    )
    return out


def has_inf(x):
    helper = LayerHelper("isinf", x=x)
    out = helper.create_variable_for_type_inference("bool")
    out.shape = ()
    helper.append_op(type="isinf_any", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_nan(x):
    helper = LayerHelper("isnan", x=x)
    out = helper.create_variable_for_type_inference("bool")
    out.shape = ()
    helper.append_op(type="isnan_any", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def isfinite(x):
    return _unary_bool("isfinite", x)


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (int(num),) if not isinstance(num, Variable) else (-1,)
    inputs = {}
    attrs = {"dtype": core.convert_dtype(dtype)}
    for key, val in (("Start", start), ("Stop", stop), ("Num", num)):
        if isinstance(val, Variable):
            inputs[key] = [val]
        else:
            attrs[key.lower()] = val
    helper.append_op(
        type="linspace", inputs=inputs, outputs={"Out": [out]}, attrs=attrs
    )
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [x]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(x.shape if x.shape else (1,)),
            "dtype": x.dtype,
            "value": 1.0,
        },
    )
    return out


def diag(diagonal):
    helper = LayerHelper("diag", **locals())
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    if diagonal.shape:
        out.shape = (diagonal.shape[0], diagonal.shape[0])
    helper.append_op(
        type="diag", inputs={"Diagonal": [diagonal]}, outputs={"Out": [out]}
    )
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    nc = num_columns or num_rows
    out.shape = (num_rows, nc)
    helper.append_op(
        type="eye",
        outputs={"Out": [out]},
        attrs={
            "num_rows": num_rows,
            "num_columns": nc,
            "dtype": core.convert_dtype(dtype),
        },
    )
    if batch_shape:
        from . import nn

        for b in reversed(batch_shape):
            out = nn.expand(nn.unsqueeze(out, [0]), [b] + [1] * (len(out.shape)))
    return out
