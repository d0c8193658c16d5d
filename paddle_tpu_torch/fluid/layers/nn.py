"""Neural-network layers (ref: python/paddle/fluid/layers/nn.py).

Port of the paddle_tpu/fluid/layers/nn.py functions that BERT, GPT, ResNet,
the MNIST models, Transformer NMT and Wide&Deep call, with
the same signatures, the same shape inference and the same ops and attrs,
so both packages build the same Program. Each function appends symbolic
ops; paddle_tpu_torch/ops lowers them to torch.
"""
from ..layer_helper import LayerHelper
from ..framework import Variable
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "dropout", "softmax", "gelu", "layer_norm", "mean",
    "conv2d", "pool2d", "batch_norm", "flatten", "topk",
    "matmul", "transpose", "reshape", "squeeze", "unsqueeze", "slice",
    "stack", "gather", "gather_nd", "expand", "expand_as", "log",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_floordiv", "scale", "reduce_sum", "reduce_max",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "sampling_id", "fused_multihead_attention", "clip", "log_loss",
]


def _layer(op_type, inputs, attrs=None, out_dtype=None, out_shape=None,
           helper=None, name_prefix=None):
    """Append a single-output op and return its out Variable."""
    helper = helper or LayerHelper(name_prefix or op_type)
    first = None
    for vs in inputs.values():
        for v in (vs if isinstance(vs, (list, tuple)) else [vs]):
            if isinstance(v, Variable):
                first = v
                break
        if first:
            break
    dtype = out_dtype or (first.dtype if first is not None else "float32")
    out = helper.create_variable_for_type_inference(dtype)
    if out_shape is not None:
        out.shape = tuple(out_shape)
    elif first is not None:
        out.shape = first.shape
    helper.append_op(
        type=op_type,
        inputs={k: (v if isinstance(v, (list, tuple)) else [v])
                for k, v in inputs.items()},
        outputs={"Out": [out]},
        attrs=attrs or {},
    )
    return out


def _prod(vals):
    r = 1
    for v in vals:
        r *= int(v)
    return r


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """Fully-connected layer (ref nn.py:189)."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param in helper.iter_inputs_and_params():
        in_shape = input_var.shape
        param_shape = [_prod(in_shape[num_flatten_dims:]), size]
        w = helper.create_parameter(
            attr=param, shape=param_shape, dtype=dtype, is_bias=False
        )
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op(
            type="sum",
            inputs={"X": mul_results},
            outputs={"Out": [pre_bias]},
            attrs={},
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """Embedding lookup (ref nn.py:344)."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False
    )
    out = helper.create_variable_for_type_inference(dtype)
    in_shape = input.shape or (-1,)
    if len(in_shape) >= 2 and in_shape[-1] == 1:
        out.shape = tuple(in_shape[:-1]) + (size[1],)
    else:
        out.shape = tuple(in_shape) + (size[1],)
    padding_idx = (
        -1
        if padding_idx is None
        else padding_idx
        if padding_idx >= 0
        else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table_v2",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse,
               "is_distributed": is_distributed},
    )
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _layer("softmax", {"X": input}, {"axis": axis})


def log(x, name=None):
    return _layer("log", {"X": x}, {})


def gelu(x, approximate=False):
    return _layer("gelu", {"X": x}, {"approximate": approximate})


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """Layer normalization (ref nn.py:2898)."""
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=Constant(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, True)
    var_out = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_out_size(i, k, p, s, d=1):
    if i in (None, -1):
        return -1
    ke = d * (k - 1) + 1
    return (i + 2 * p - ke) // s + 1


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    """2-D convolution (ref nn.py:1105); the filter drawn from
    Normal(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    def _std(shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=Normal(0.0, _std(filter_shape)),
    )
    out = helper.create_variable_for_type_inference(dtype)
    n, _, h, wdt = input.shape
    out.shape = (
        n,
        num_filters,
        _conv_out_size(h, filter_size[0], padding[0], stride[0], dilation[0]),
        _conv_out_size(wdt, filter_size[1], padding[1], stride[1], dilation[1]),
    )
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "data_format": data_format,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    name=None,
    exclusive=True,
    data_format="NCHW",
):
    helper = LayerHelper("pool2d", **locals())
    pool_size = _pair(pool_size)
    pool_stride = _pair(pool_stride)
    pool_padding = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(input.dtype)
    n, c, h, w = input.shape
    if global_pooling:
        out.shape = (n, c, 1, 1)
    else:
        def _po(i, k, p, s):
            if i in (None, -1):
                return -1
            if ceil_mode:
                return -(-(i + 2 * p - k) // s) + 1
            return (i + 2 * p - k) // s + 1
        out.shape = (
            n,
            c,
            _po(h, pool_size[0], pool_padding[0], pool_stride[0]),
            _po(w, pool_size[1], pool_padding[1], pool_stride[1]),
        )
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": pool_stride,
            "paddings": pool_padding,
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=True,
    use_global_stats=False,
):
    """Batch normalization (ref nn.py:2372). The moving mean and variance
    are persistable, not trainable, and stop the gradient; the op writes
    them back under their own names once per step."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]

    scale = helper.create_parameter(
        attr=helper.param_attr,
        shape=param_shape,
        dtype=dtype,
        default_initializer=Constant(1.0),
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
    )
    mean = helper.create_parameter(
        attr=ParamAttr(
            name=moving_mean_name, initializer=Constant(0.0),
            trainable=False,
            do_model_average=do_model_average_for_mean_and_var,
        ),
        shape=param_shape,
        dtype=dtype,
    )
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(
            name=moving_variance_name,
            initializer=Constant(1.0),
            trainable=False,
            do_model_average=do_model_average_for_mean_and_var,
        ),
        shape=param_shape,
        dtype=dtype,
    )
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype, True)
    saved_var = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="batch_norm",
        inputs={
            "X": [input],
            "Scale": [scale],
            "Bias": [bias],
            "Mean": [mean],
            "Variance": [variance],
        },
        outputs={
            "Y": [out],
            "MeanOut": [mean],
            "VarianceOut": [variance],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_var],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


def mean(x, name=None):
    return _layer("mean", {"X": x}, out_shape=())


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None:
        xs = list(x.shape)
        ys = list(y.shape)
        if transpose_x and len(xs) >= 2:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) >= 2:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        if len(xs) >= 2 and len(ys) >= 2:
            batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
            out.shape = tuple(batch + [xs[-2], ys[-1]])
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={
            "transpose_X": transpose_x,
            "transpose_Y": transpose_y,
            "alpha": float(alpha),
        },
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    if x.shape is not None:
        out.shape = tuple(x.shape[p] for p in perm)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": list(perm)},
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    if x.shape is not None and all(
        s not in (None, -1) for s in x.shape
    ):
        total = _prod(x.shape)
        s2 = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        if -1 in s2:
            known = _prod([s for s in s2 if s != -1])
            s2[s2.index(-1)] = total // known
        out.shape = tuple(s2)
    else:
        out.shape = tuple(s if s != 0 else (x.shape[i] if x.shape else -1)
                          for i, s in enumerate(shape))
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    if input.shape is not None:
        nd = len(input.shape)
        drop = {a % nd for a in axes if input.shape[a % nd] == 1}
        out.shape = tuple(
            s for i, s in enumerate(input.shape) if i not in drop
        )
    helper.append_op(
        type="squeeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": list(axes)},
    )
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    if input.shape is not None:
        s = list(input.shape)
        for a in sorted(axes):
            s.insert(a if a >= 0 else a + len(s) + 1, 1)
        out.shape = tuple(s)
    helper.append_op(
        type="unsqueeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": list(axes)},
    )
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    if x.shape is not None:
        lead = _prod(x.shape[:axis]) if all(
            s not in (None, -1) for s in x.shape[:axis]
        ) else -1
        tail = _prod(x.shape[axis:]) if all(
            s not in (None, -1) for s in x.shape[axis:]
        ) else -1
        out.shape = (lead, tail)
    helper.append_op(
        type="flatten2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": axis},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    inputs = {"X": [input]}
    attrs = {}
    if isinstance(k, Variable):
        inputs["K"] = [k]
        kk = -1
    else:
        attrs["k"] = k
        kk = k
    if input.shape is not None:
        s = list(input.shape)
        s[-1] = kk
        values.shape = tuple(s)
        indices.shape = tuple(s)
    helper.append_op(
        type="top_k",
        inputs=inputs,
        outputs={"Out": [values], "Indices": [indices]},
        attrs=attrs,
    )
    values.stop_gradient = False
    indices.stop_gradient = True
    return values, indices


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        s = list(input.shape)
        for ax, st, en in zip(axes, starts, ends):
            if s[ax] in (None, -1):
                continue
            dim = s[ax]
            st2 = max(st + dim, 0) if st < 0 else min(st, dim)
            en2 = max(en + dim, 0) if en < 0 else min(en, dim)
            s[ax] = max(en2 - st2, 0)
        out.shape = tuple(s)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack", x=x, axis=axis)
    if not isinstance(x, (list, tuple)):
        x = [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    if x[0].shape is not None:
        s = list(x[0].shape)
        ax = axis if axis >= 0 else axis + len(s) + 1
        s.insert(ax, len(x))
        out.shape = tuple(s)
    helper.append_op(
        type="stack",
        inputs={"X": list(x)},
        outputs={"Y": [out]},
        attrs={"axis": axis},
    )
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and index.shape is not None:
        out.shape = tuple([index.shape[0]] + list(input.shape[1:]))
    helper.append_op(
        type="gather",
        inputs={"X": [input], "Index": [index]},
        outputs={"Out": [out]},
    )
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(
            s * t if s not in (None, -1) else -1
            for s, t in zip(x.shape, expand_times)
        )
    helper.append_op(
        type="expand",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = target_tensor.shape
    helper.append_op(
        type="expand_as",
        inputs={"X": [x], "target_tensor": [target_tensor]},
        outputs={"Out": [out]},
    )
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and index.shape is not None:
        k = index.shape[-1]
        out.shape = tuple(list(index.shape[:-1]) + list(input.shape[k:]))
    helper.append_op(
        type="gather_nd",
        inputs={"X": [input], "Index": [index]},
        outputs={"Out": [out]},
    )
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, x=x, y=y, axis=axis, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = x.shape
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def _logical(op_type, x, y=None, out=None, name=None):
    helper = LayerHelper(op_type, x=x, y=y, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
        out.shape = x.shape
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out, name)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id", **locals())
    out = helper.create_variable_for_type_inference("int64")
    if x.shape is not None:
        out.shape = (x.shape[0],)
    helper.append_op(
        type="sampling_id",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"min": min, "max": max, "seed": seed},
    )
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", **locals())
    inputs = {"X": [x]}
    attrs = {"bias": float(bias), "bias_after_scale": bias_after_scale}
    if isinstance(scale, Variable):
        inputs["ScaleTensor"] = [scale]
    else:
        attrs["scale"] = float(scale)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="scale", inputs=inputs, outputs={"Out": [out]}, attrs=attrs
    )
    return helper.append_activation(out)


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, input=input)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        if dim is None:
            out.shape = () if not keep_dim else (1,) * len(input.shape)
        else:
            s = list(input.shape)
            for a in sorted([d % len(s) for d in dim], reverse=True):
                if keep_dim:
                    s[a] = 1
                else:
                    s.pop(a)
            out.shape = tuple(s)
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"dim": dim, "keep_dim": keep_dim, "reduce_all": dim is None},
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def fused_multihead_attention(query, key, value, key_padding_mask=None,
                              causal=False, dropout_rate=0.0, name=None):
    """Fused scaled-dot-product multi-head attention; lowers to the
    hand-written flash-attention kernel (ops/cuda_attention.py) on the
    card.

    query/key/value: (B, H, T, D) Variables. key_padding_mask: optional
    additive (B, T_k) float mask (-1e30 at padded keys).
    """
    inputs = {"Q": query, "K": key, "V": value}
    if key_padding_mask is not None:
        inputs["KeyPaddingMask"] = key_padding_mask
    return _layer(
        "fused_multihead_attention",
        inputs,
        {"causal": causal, "dropout_prob": dropout_rate},
    )


def clip(x, min, max, name=None):
    return _layer("clip", {"X": x}, {"min": float(min), "max": float(max)})


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input], "Labels": [label]},
        outputs={"Loss": [out]},
        attrs={"epsilon": epsilon},
    )
    return out
