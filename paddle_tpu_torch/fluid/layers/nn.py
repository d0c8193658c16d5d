"""Neural-network layers (ref: python/paddle/fluid/layers/nn.py).

Port of the paddle_tpu/fluid/layers/nn.py functions that BERT, GPT, ResNet,
the MNIST models, Transformer NMT, Wide&Deep, the recurrent book
chapters (``cross_entropy``), SSD (``one_hot``), the R-CNN family (the
ROI layers, ``deformable_conv``) and the SRL chapter (the CRF layers)
call, with
the same signatures, the same shape inference and the same ops and attrs,
so both packages build the same Program. Each function appends symbolic
ops; paddle_tpu_torch/ops lowers them to torch.
"""
from .. import core
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
    "elementwise_mod", "elementwise_floordiv", "elementwise_pow",
    "elementwise_equal", "scale", "reduce_sum", "reduce_mean", "reduce_max",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "sampling_id", "fused_multihead_attention", "clip", "clip_by_norm",
    "log_loss", "sign", "pow", "autoincreased_step_counter",
    "cross_entropy", "one_hot", "one_hot_v2", "psroi_pool", "prroi_pool",
    "deformable_conv", "roi_pool", "roi_align", "linear_chain_crf",
    "crf_decoding", "chunk_eval", "ctc_greedy_decoder",
    "relu", "selu", "relu6", "hard_sigmoid", "hard_swish", "swish", "brelu",
    "leaky_relu", "soft_relu", "elu", "stanh", "maxout", "prelu",
    "reduce_min", "reduce_prod", "reduce_all", "reduce_any", "split",
    "l2_normalize", "mul", "sum", "cos_sim", "bilinear_tensor_product",
    "mean_iou", "square_error_cost", "smooth_l1", "dice_loss", "kldiv_loss",
    "npair_loss", "mse_loss",
    "conv3d", "pool3d", "adaptive_pool2d", "adaptive_pool3d",
    "instance_norm", "group_norm", "spectral_norm", "conv2d_transpose",
    "conv3d_transpose", "unstack", "uniform_random_batch_size_like",
    "gaussian_random", "gaussian_random_batch_size_like", "strided_slice",
    "shape", "rank", "size", "scatter", "scatter_nd_add", "scatter_nd",
    "random_crop", "crop", "crop_tensor", "pad", "pad_constant_like",
    "label_smooth", "image_resize", "resize_bilinear", "resize_nearest",
    "resize_trilinear", "pad2d", "where", "space_to_depth",
    "affine_channel", "grid_sampler", "affine_grid", "pixel_shuffle",
    "temporal_shift", "multiplex", "unique", "unique_with_counts",
    "flatten_contiguous", "im2sequence", "row_conv", "py_func", "tree_conv",
    "image_resize_short", "similarity_focus", "merge_selected_rows",
    "get_tensor_from_selected_rows", "deformable_roi_pooling",
    "shard_index", "hash", "mish", "unfold", "lrn", "shuffle_channel",
    "add_position_encoding", "continuous_value_model", "fsp_matrix",
    "data_norm", "filter_by_instag",
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


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_equal(x, y, name=None):
    return _layer("equal", {"X": x, "Y": y}, out_dtype="bool")


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


def _reduce(op_type, input, dim=None, keep_dim=False, name=None,
            dtype=None):
    helper = LayerHelper(op_type, input=input)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    out = helper.create_variable_for_type_inference(dtype or input.dtype)
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


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


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


def clip_by_norm(x, max_norm, name=None):
    return _layer("clip_by_norm", {"X": x}, {"max_norm": float(max_norm)})


def sign(x):
    return _layer("sign", {"X": x}, {})


def pow(x, factor=1.0, name=None):
    if isinstance(factor, Variable):
        return _layer("pow", {"X": x, "FactorTensor": factor})
    return _layer("pow", {"X": x}, {"factor": factor})


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 step counter incremented once per executor run
    (ref nn.py:5327): the first call for a name prepends its ``increment``
    to the block."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True)
    if not helper.startup_program.global_block().has_var(counter_name):
        helper.set_variable_initializer(
            counter, Constant(value=float(begin - 1)))
        helper.main_program.current_block()._prepend_op(
            type="increment", inputs={"X": [counter]},
            outputs={"Out": [counter]}, attrs={"step": float(step)})
        counter.stop_gradient = True
    return counter


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        out.shape = tuple(list(input.shape[:-1]) + [1])
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


# ---------------------------------------------------------------------------
# ids, ROI pooling, deformable convolution, CRF and CTC decoding
# ---------------------------------------------------------------------------
def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    s = input.shape or (-1, 1)
    if s[-1] == 1:
        out.shape = tuple(s[:-1]) + (depth,)
    else:
        out.shape = tuple(s) + (depth,)
    helper.append_op(
        type="one_hot",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"depth": depth, "allow_out_of_range": allow_out_of_range},
    )
    return out


def one_hot_v2(input, depth, allow_out_of_range=False):
    return one_hot(input, depth, allow_out_of_range)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    """Position-sensitive ROI pooling for R-FCN (ref nn.py:12409)."""
    helper = LayerHelper("psroi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if rois.shape is not None:
        out.shape = (rois.shape[0], output_channels, pooled_height,
                     pooled_width)
    helper.append_op(
        type="psroi_pool",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={
            "output_channels": output_channels,
            "spatial_scale": spatial_scale,
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
        },
    )
    return out


def prroi_pool(input, rois, spatial_scale=1.0,
               pooled_height=1, pooled_width=1, name=None,
               output_channels=None):
    """Precise ROI pooling (ref nn.py:12475): integral of the bilinear
    surface over each bin, differentiable in the roi coordinates."""
    helper = LayerHelper("prroi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if rois.shape is not None and input.shape is not None:
        out.shape = (rois.shape[0], input.shape[1], pooled_height,
                     pooled_width)
    helper.append_op(
        type="prroi_pool",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={
            "spatial_scale": spatial_scale,
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
        },
    )
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    """Deformable convolution v2 (modulated=True) / v1 (ref nn.py:12868):
    samples at offset-shifted tap positions, optionally mask-modulated."""
    helper = LayerHelper("deformable_conv", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    deformable_groups = deformable_groups or 1
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    num_channels = input.shape[1]
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, num_channels // groups] + filter_size,
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)

    def _o(i, k, p, s, d):
        if i in (None, -1):
            return -1
        return (i + 2 * p - d * (k - 1) - 1) // s + 1

    if input.shape is not None:
        out.shape = (
            input.shape[0], num_filters,
            _o(input.shape[2], filter_size[0], padding[0], stride[0],
               dilation[0]),
            _o(input.shape[3], filter_size[1], padding[1], stride[1],
               dilation[1]),
        )
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated:
        if mask is None:
            raise ValueError("deformable_conv(modulated=True) needs a mask")
        ins["Mask"] = [mask]
    helper.append_op(
        type="deformable_conv",
        inputs=ins,
        outputs={"Output": [out]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "deformable_groups": deformable_groups,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    helper = LayerHelper("roi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax_ = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        type="roi_pool",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out], "Argmax": [argmax_]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_align",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
            "sampling_ratio": sampling_ratio,
        },
    )
    return out

def _length_or_companion(helper, var, length):
    """Explicit length var, else the LoD @SEQ_LEN companion, else None."""
    if length is not None:
        return length
    from .sequence_lod import _seq_len_var

    return _seq_len_var(var)


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Linear-chain CRF negative log likelihood (ref nn.py:534).

    input: (B, T, D) padded emissions (or a LoD var with an @SEQ_LEN
    companion); label: (B, T) or (B, T, 1) int; length: (B,) or (B, 1)
    int lengths (optional when input carries LoD lengths). Creates the
    (D+2, D) transition parameter (row 0 start, row 1 end, rows 2+
    tag->tag) and returns the per-sequence cost (B, 1).
    """
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size],
        dtype=helper.input_dtype(),
    )
    alpha = helper.create_variable_for_type_inference(helper.input_dtype())
    emission_exps = helper.create_variable_for_type_inference(
        helper.input_dtype()
    )
    transition_exps = helper.create_variable_for_type_inference(
        helper.input_dtype()
    )
    log_likelihood = helper.create_variable_for_type_inference(
        helper.input_dtype()
    )
    log_likelihood.shape = (input.shape[0], 1)
    ins = {"Emission": [input], "Transition": [transition],
           "Label": [label]}
    length = _length_or_companion(helper, input, length)
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(
        type="linear_chain_crf",
        inputs=ins,
        outputs={
            "Alpha": [alpha],
            "EmissionExps": [emission_exps],
            "TransitionExps": [transition_exps],
            "LogLikelihood": [log_likelihood],
        },
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the linear_chain_crf transition parameter
    (ref nn.py:654). Returns (B, T) int64 best tags (or, when `label` is
    given, a per-token correctness indicator)."""
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_variable_for_type_inference("int64")
    if input.shape is not None and len(input.shape) >= 2:
        viterbi_path.shape = tuple(input.shape[:-1])
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    length = _length_or_companion(helper, input, length)
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(
        type="crf_decoding",
        inputs=ins,
        outputs={"ViterbiPath": [viterbi_path]},
    )
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision/recall/F1 for sequence labeling
    (ref nn.py:1380; op: chunk_eval_op.h). Returns (precision, recall,
    f1, num_infer_chunks, num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval", **locals())
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1_score = helper.create_variable_for_type_inference("float32")
    num_infer_chunks = helper.create_variable_for_type_inference("int64")
    num_label_chunks = helper.create_variable_for_type_inference("int64")
    num_correct_chunks = helper.create_variable_for_type_inference("int64")
    for v in (precision, recall, f1_score):
        v.shape = (1,)
    for v in (num_infer_chunks, num_label_chunks, num_correct_chunks):
        v.shape = (1,)
    ins = {"Inference": [input], "Label": [label]}
    seq_length = _length_or_companion(helper, input, seq_length)
    if seq_length is not None:
        ins["SeqLength"] = [seq_length]
    helper.append_op(
        type="chunk_eval",
        inputs=ins,
        outputs={
            "Precision": [precision],
            "Recall": [recall],
            "F1-Score": [f1_score],
            "NumInferChunks": [num_infer_chunks],
            "NumLabelChunks": [num_label_chunks],
            "NumCorrectChunks": [num_correct_chunks],
        },
        attrs={
            "num_chunk_types": num_chunk_types,
            "chunk_scheme": chunk_scheme,
            "excluded_chunk_types": list(excluded_chunk_types or []),
        },
    )
    return (precision, recall, f1_score, num_infer_chunks,
            num_label_chunks, num_correct_chunks)


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decoding (ref nn.py:4652): per-frame argmax, merge
    repeats, drop blanks. input: (B, T, C) probs/logits. Returns
    (decoded (B, T) int64 padded with padding_value, out_length (B, 1))
    — always padded-mode outputs (the LoD representation is
    dense-padded)."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    if input.shape is not None and len(input.shape) >= 2:
        out.shape = tuple(input.shape[:-1])
        out_len.shape = (input.shape[0], 1)
    ins = {"Input": [input]}
    input_length = _length_or_companion(helper, input, input_length)
    if input_length is not None:
        ins["InputLength"] = [input_length]
    helper.append_op(
        type="ctc_greedy_decoder",
        inputs=ins,
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"blank": blank, "padding_value": padding_value},
    )
    return out, out_len


# ---------------------------------------------------------------------------
# activations with extra args (ref nn.py:209-300)
# ---------------------------------------------------------------------------
def _unary(op_type, x, attrs=None, name=None):
    return _layer(op_type, {"X": x}, attrs or {})


def relu(x, name=None):
    return _unary("relu", x)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _unary("selu", x, attrs)


def relu6(x, threshold=6.0, name=None):
    return _unary("relu6", x, {"threshold": threshold})


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary("hard_sigmoid", x, {"slope": slope, "offset": offset})


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    """x * relu6(x + offset) / scale (ref nn.py hard_swish)."""
    return _unary(
        "hard_swish", x,
        {"threshold": threshold, "scale": scale, "offset": offset},
    )


def swish(x, beta=1.0, name=None):
    return _unary("swish", x, {"beta": beta})


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary("brelu", x, {"t_min": t_min, "t_max": t_max})


def leaky_relu(x, alpha=0.02, name=None):
    return _unary("leaky_relu", x, {"alpha": alpha})


def soft_relu(x, threshold=40.0, name=None):
    return _unary("soft_relu", x, {"threshold": threshold})


def elu(x, alpha=1.0, name=None):
    return _unary("elu", x, {"alpha": alpha})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary("stanh", x, {"scale_a": scale_a, "scale_b": scale_b})


def maxout(x, groups, name=None, axis=1):
    # the reference makes a helper it does not use; its name is taken all
    # the same, and the op's output is named after the next one
    LayerHelper("maxout", **locals())
    out_shape = None
    if x.shape is not None:
        s = list(x.shape)
        s[axis] = s[axis] // groups
        out_shape = s
    return _layer("maxout", {"X": x}, {"groups": groups, "axis": axis},
                  out_shape=out_shape)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", **locals())
    alpha_shape = [1]
    if mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1] if len(x.shape) == 4 \
            else [x.shape[1]]
    elif mode == "element":
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr,
        shape=alpha_shape,
        dtype="float32",
        is_bias=False,
        default_initializer=Constant(0.25),
    )
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="prelu",
        inputs={"X": [x], "Alpha": [alpha]},
        outputs={"Out": [out]},
        attrs={"mode": mode},
    )
    return out


# ---------------------------------------------------------------------------
# reductions, split, l2_normalize, mul, sum (ref nn.py:1149-1199,
# 1629-1648)
# ---------------------------------------------------------------------------
def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name, dtype="bool")


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name, dtype="bool")


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    in_shape = input.shape
    ax = dim if dim >= 0 else dim + len(in_shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
        sizes = [in_shape[ax] // n if in_shape[ax] not in (None, -1)
                 else -1] * n
    else:
        sizes = list(num_or_sections)
        attrs = {"num": 0, "sections": sizes, "axis": dim}
    outs = []
    for sz in sizes:
        o = helper.create_variable_for_type_inference(input.dtype)
        s = list(in_shape)
        s[ax] = sz
        o.shape = tuple(s)
        outs.append(o)
    helper.append_op(
        type="split", inputs={"X": [input]}, outputs={"Out": outs},
        attrs=attrs
    )
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, True)
    out.shape = x.shape
    helper.append_op(
        type="l2_normalize",
        inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None:
        out.shape = tuple(
            list(x.shape[:x_num_col_dims]) + list(y.shape[y_num_col_dims:])
        )
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={
            "x_num_col_dims": x_num_col_dims,
            "y_num_col_dims": y_num_col_dims,
        },
    )
    return out


def sum(x):
    helper = LayerHelper("sum", x=x)
    if not isinstance(x, (list, tuple)):
        x = [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    out.shape = x[0].shape
    helper.append_op(type="sum", inputs={"X": list(x)},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# cos_sim, bilinear_tensor_product, mean_iou (ref nn.py:2026, 2324, 2355)
# ---------------------------------------------------------------------------
def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", X=X, Y=Y)
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype, True)
    ynorm = helper.create_variable_for_type_inference(X.dtype, True)
    if X.shape is not None:
        out.shape = tuple(list(X.shape[:-1]) + [1])
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", **locals())
    dtype = helper.input_dtype("x")
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[size, x.shape[1], y.shape[1]],
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (x.shape[0], size)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype, is_bias=True
        )
        if bias is not None:
            inputs["Bias"] = [bias]
    helper.append_op(
        type="bilinear_tensor_product",
        inputs=inputs,
        outputs={"Out": [out]},
    )
    return helper.append_activation(out)


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou", **locals())
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    miou.shape = ()
    helper.append_op(
        type="mean_iou",
        inputs={"Predictions": [input], "Labels": [label]},
        outputs={
            "OutMeanIou": [miou],
            "OutWrong": [wrong],
            "OutCorrect": [correct],
        },
        attrs={"num_classes": num_classes},
    )
    return miou, wrong, correct


# ---------------------------------------------------------------------------
# losses (ref nn.py:2563-2650)
# ---------------------------------------------------------------------------
def square_error_cost(input, label):
    return _layer(
        "square_error_cost", {"X": input, "Y": label}, out_shape=input.shape
    )


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss", **locals())
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = (x.shape[0], 1)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Out": [out], "Diff": [diff]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return out


def dice_loss(input, label, epsilon=1e-5, name=None):
    return _layer(
        "dice_loss", {"X": input, "Label": label}, {"epsilon": epsilon},
        out_shape=(),
    )


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = () if reduction != "none" else x.shape
    helper.append_op(
        type="kldiv_loss",
        inputs={"X": [x], "Target": [target]},
        outputs={"Loss": [out]},
        attrs={"reduction": reduction},
    )
    return out


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss composed from other ops, as the reference's layer
    composes it (its npair_loss_helper op has no lowering)."""
    batch = anchor.shape[0]
    labels_ = reshape(labels, [-1, 1])
    eq = _layer("equal", {"X": labels_, "Y": transpose(labels_, [1, 0])},
                out_dtype="bool", out_shape=(batch, batch))
    eqf = _layer("cast", {"X": eq}, {"out_dtype": "float32"},
                 out_dtype="float32", out_shape=(batch, batch))
    denom = reduce_sum(eqf, dim=[1], keep_dim=True)
    target = elementwise_div(eqf, denom)
    sim = matmul(anchor, positive, transpose_y=True)
    from .loss import softmax_with_cross_entropy

    ce = softmax_with_cross_entropy(sim, target, soft_label=True)
    celoss = reduce_mean(ce)
    l2 = scale(
        elementwise_add(
            reduce_mean(reduce_sum(elementwise_mul(anchor, anchor), dim=[1])),
            reduce_mean(reduce_sum(elementwise_mul(positive, positive),
                                   dim=[1]))),
        scale=l2_reg * 0.25,
    )
    return elementwise_add(celoss, l2)


def mse_loss(input, label):
    return _layer("mse_loss", {"X": input, "Y": label}, out_shape=())


# ---------------------------------------------------------------------------
# the rest of paddle_tpu/fluid/layers/nn.py (ref nn.py): 3-D and transposed
# convolutions, pool3d and the adaptive pools, the norms, shape and index
# layers, pads and crops, resizes and samplers, the misc and random layers
# ---------------------------------------------------------------------------
def mish(x, threshold=20.0, name=None):
    helper = LayerHelper("mish", **locals())
    sp = _unary("softplus", x)
    th = _unary("tanh", sp)
    return elementwise_mul(x, th)


def conv3d(
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
    data_format="NCDHW",
):
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair(filter_size, 3)
    stride = _pair(stride, 3)
    padding = _pair(padding, 3)
    dilation = _pair(dilation, 3)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    n = input.shape[0]
    spatial = [
        _conv_out_size(i, k, p, s, d)
        for i, k, p, s, d in zip(
            input.shape[2:], filter_size, padding, stride, dilation
        )
    ]
    out.shape = tuple([n, num_filters] + spatial)
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _pair(output_size)
        filter_size = [
            output_size[i]
            - (input.shape[i + 2] - 1) * stride[i]
            + 2 * padding[i]
            - 1 + 1
            for i in range(2)
        ]
        filter_size = [
            (output_size[i] + 2 * padding[i] - (input.shape[i + 2] - 1) * stride[i] - 1) // dilation[i] + 1
            for i in range(2)
        ]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_channels, num_filters // groups] + filter_size,
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)
    def _o(i, k, p, s, d):
        if i in (None, -1):
            return -1
        return (i - 1) * s - 2 * p + d * (k - 1) + 1
    out_padding = _resolve_output_padding(
        output_size, filter_size, input.shape[2:4], padding, stride,
        dilation, 2, _pair, _o,
    )
    out.shape = (
        input.shape[0],
        num_filters,
        _o(input.shape[2], filter_size[0], padding[0], stride[0],
           dilation[0]) + out_padding[0],
        _o(input.shape[3], filter_size[1], padding[1], stride[1],
           dilation[1]) + out_padding[1],
    )
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "output_padding": out_padding,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def _resolve_output_padding(output_size, filter_size, in_spatial, padding,
                            stride, dilation, ndim, pair, out_fn):
    """When output_size is given, the stride>1 ambiguity is resolved by
    extending the bottom/right edge (ref conv_transpose_op.cc): returns
    the per-dim extra rows, validated to lie in [0, stride)."""
    if output_size is None:
        return [0] * ndim
    output_size = pair(output_size, ndim)
    extra = []
    for i in range(ndim):
        base = out_fn(in_spatial[i], filter_size[i], padding[i], stride[i],
                      dilation[i])
        e = output_size[i] - base
        if base != -1 and not 0 <= e < stride[i]:
            raise ValueError(
                "conv_transpose output_size[%d]=%d unreachable: valid "
                "range is [%d, %d)" % (i, output_size[i], base,
                                       base + stride[i])
            )
        extra.append(max(e, 0) if base != -1 else 0)
    return extra


def conv3d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCDHW",
):
    """3-D transposed convolution (ref nn.py conv3d_transpose)."""
    helper = LayerHelper("conv3d_transpose", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    stride = _pair(stride, 3)
    padding = _pair(padding, 3)
    dilation = _pair(dilation, 3)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _pair(output_size, 3)
        filter_size = [
            (output_size[i] + 2 * padding[i]
             - (input.shape[i + 2] - 1) * stride[i] - 1) // dilation[i] + 1
            for i in range(3)
        ]
    else:
        filter_size = _pair(filter_size, 3)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_channels, num_filters // groups] + filter_size,
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)

    def _o(i, k, p, s, d):
        if i in (None, -1):
            return -1
        return (i - 1) * s - 2 * p + d * (k - 1) + 1

    out_padding = _resolve_output_padding(
        output_size, filter_size, input.shape[2:5], padding, stride,
        dilation, 3, _pair, _o,
    )
    out.shape = tuple(
        [input.shape[0], num_filters]
        + [
            _o(input.shape[i + 2], filter_size[i], padding[i], stride[i],
               dilation[i]) + out_padding[i]
            for i in range(3)
        ]
    )
    helper.append_op(
        type="conv3d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "output_padding": out_padding,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(
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
    data_format="NCDHW",
):
    helper = LayerHelper("pool3d", **locals())
    pool_size = _pair(pool_size, 3)
    pool_stride = _pair(pool_stride, 3)
    pool_padding = _pair(pool_padding, 3)
    out = helper.create_variable_for_type_inference(input.dtype)
    n, c = input.shape[:2]
    if global_pooling:
        out.shape = (n, c, 1, 1, 1)
    else:
        sp = [
            (i + 2 * p - k) // s + 1 if i not in (None, -1) else -1
            for i, k, p, s in zip(
                input.shape[2:], pool_size, pool_padding, pool_stride
            )
        ]
        out.shape = tuple([n, c] + sp)
    helper.append_op(
        type="pool3d",
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


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Adaptive 3-D pooling to a fixed (D, H, W) output (ref nn.py
    adaptive_pool3d) — pool3d op with adaptive windows."""
    if require_index:
        raise NotImplementedError(
            "adaptive_pool3d(require_index=True): the max-index mask is "
            "not emitted by the pool lowering — compute argmax windows "
            "explicitly if needed"
        )
    helper = LayerHelper("adaptive_pool3d", **locals())
    pool_size = _pair(pool_size, 3)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = tuple(
        [input.shape[0], input.shape[1]] + list(pool_size)
    )
    helper.append_op(
        type="pool3d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(pool_size),
            "strides": [1, 1, 1],
            "paddings": [0, 0, 0],
            "adaptive": True,
            "global_pooling": False,
            "ceil_mode": False,
            "exclusive": True,
        },
    )
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        raise NotImplementedError(
            "adaptive_pool2d(require_index=True): the max-index mask is "
            "not emitted by the pool lowering — compute argmax windows "
            "explicitly if needed"
        )
    helper = LayerHelper("adaptive_pool2d", **locals())
    pool_size = _pair(pool_size)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (input.shape[0], input.shape[1], pool_size[0], pool_size[1])
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": [1, 1],
            "paddings": [0, 0],
            "adaptive": True,
            "global_pooling": False,
            "ceil_mode": False,
            "exclusive": True,
        },
    )
    return out


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1]
    scale = helper.create_parameter(
        attr=helper.param_attr,
        shape=[channels],
        dtype=dtype,
        default_initializer=Constant(1.0),
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[channels], dtype=dtype, is_bias=True
    )
    saved_mean = helper.create_variable_for_type_inference(dtype, True)
    saved_var = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="instance_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias]},
        outputs={
            "Y": [out],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_var],
        },
        attrs={"epsilon": epsilon},
    )
    return out


def group_norm(
    input,
    groups,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    act=None,
    data_layout="NCHW",
    name=None,
):
    helper = LayerHelper("group_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=[channels],
            dtype=dtype,
            default_initializer=Constant(1.0),
        )
        inputs["Scale"] = [s]
    if bias_attr is not False:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=[channels], dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, True)
    var_out = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="group_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "groups": groups},
    )
    return helper.append_activation(out)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper("spectral_norm", **locals())
    dtype = weight.dtype
    h = weight.shape[dim]
    w = _prod(weight.shape) // h
    u = helper.create_parameter(
        attr=ParamAttr(initializer=Normal(0.0, 1.0), trainable=False),
        shape=[h],
        dtype=dtype,
    )
    u.stop_gradient = True
    v = helper.create_parameter(
        attr=ParamAttr(initializer=Normal(0.0, 1.0), trainable=False),
        shape=[w],
        dtype=dtype,
    )
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = weight.shape
    helper.append_op(
        type="spectral_norm",
        inputs={"Weight": [weight], "U": [u], "V": [v]},
        outputs={"Out": [out]},
        attrs={"dim": dim, "power_iters": power_iters, "eps": eps},
    )
    return out


def data_norm(
    input,
    act=None,
    epsilon=1e-05,
    param_attr=None,
    data_layout="NCHW",
    in_place=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=True,
    slot_dim=-1,
    sync_stats=False,
    summary_decay_rate=0.9999999,
):
    # slot_dim / sync_stats / summary_decay_rate (ref nn.py data_norm) are
    # CTR-pserver knobs the dense path does not read
    helper = LayerHelper("data_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[1]
    _stat_avg = do_model_average_for_mean_and_var
    batch_size = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(1e4),
                       do_model_average=_stat_avg), shape=[c], dtype=dtype
    )
    batch_sum = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(0.0),
                       do_model_average=_stat_avg), shape=[c], dtype=dtype
    )
    batch_square = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(1e4),
                       do_model_average=_stat_avg), shape=[c], dtype=dtype
    )
    means = helper.create_variable_for_type_inference(dtype, True)
    scales = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="data_norm",
        inputs={
            "X": [input],
            "BatchSize": [batch_size],
            "BatchSum": [batch_sum],
            "BatchSquareSum": [batch_square],
        },
        outputs={"Y": [out], "Means": [means], "Scales": [scales]},
        attrs={"epsilon": epsilon},
    )
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format="NCHW"):
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    out.shape = input.shape
    helper.append_op(
        type="lrn",
        inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def flatten_contiguous(x, start_axis=0, stop_axis=-1):
    """Collapse dims [start_axis, stop_axis] into one (reshape, not the
    2-D flatten op)."""
    ndim = len(x.shape)
    lo = start_axis + ndim if start_axis < 0 else start_axis
    hi = stop_axis + ndim if stop_axis < 0 else stop_axis
    if not (0 <= lo <= hi < ndim):
        raise ValueError(
            "flatten_contiguous: invalid axes (%d, %d) for rank %d"
            % (start_axis, stop_axis, ndim)
        )
    mid = 1
    for s in x.shape[lo:hi + 1]:
        mid = -1 if (s in (None, -1) or mid == -1) else mid * int(s)
    new_shape = list(x.shape[:lo]) + [mid] + list(x.shape[hi + 1:])
    return reshape(x, new_shape)


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack", **locals())
    if num is None:
        num = x.shape[axis]
    outs = []
    s = list(x.shape)
    s.pop(axis if axis >= 0 else axis + len(s))
    for _ in range(num):
        o = helper.create_variable_for_type_inference(x.dtype)
        o.shape = tuple(s)
        outs.append(o)
    helper.append_op(
        type="unstack",
        inputs={"X": [x]},
        outputs={"Y": outs},
        attrs={"axis": axis, "num": num},
    )
    return outs


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="strided_slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "axes": list(axes),
            "starts": list(starts),
            "ends": list(ends),
            "strides": list(strides),
        },
    )
    return out


def shape(input):
    helper = LayerHelper("shape", **locals())
    out = helper.create_variable_for_type_inference("int32", True)
    out.shape = (len(input.shape),) if input.shape is not None else (-1,)
    helper.append_op(
        type="shape", inputs={"Input": [input]}, outputs={"Out": [out]}
    )
    return out


def rank(input):
    return tensor_fill_int(len(input.shape), "int32")


def tensor_fill_int(value, dtype):
    from . import tensor as t

    return t.fill_constant(shape=[1], dtype=dtype, value=value)


def size(input):
    helper = LayerHelper("size", **locals())
    out = helper.create_variable_for_type_inference("int64", True)
    out.shape = ()
    helper.append_op(
        type="size", inputs={"Input": [input]}, outputs={"Out": [out]}
    )
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
        attrs={"overwrite": overwrite},
    )
    return out


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", **locals())
    out = helper.create_variable_for_type_inference(ref.dtype)
    out.shape = ref.shape
    helper.append_op(
        type="scatter_nd_add",
        inputs={"X": [ref], "Index": [index], "Updates": [updates]},
        outputs={"Out": [out]},
    )
    return out


def scatter_nd(index, updates, shape, name=None):
    from . import tensor as t

    zeros_ = t.fill_constant(shape, updates.dtype, 0.0)
    return scatter_nd_add(zeros_, index, updates, name)


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(list(x.shape[: len(x.shape) - len(shape)]) + list(shape))
    helper.append_op(
        type="random_crop",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "seed": seed or 0},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out_shape = None
    if x.shape is not None:
        out_shape = [
            s + paddings[2 * i] + paddings[2 * i + 1] if s not in (None, -1) else -1
            for i, s in enumerate(x.shape)
        ]
    return _layer(
        "pad",
        {"X": x},
        {"paddings": list(paddings), "pad_value": float(pad_value)},
        out_shape=out_shape,
    )


def pad2d(
    input,
    paddings=[0, 0, 0, 0],
    mode="constant",
    pad_value=0.0,
    data_format="NCHW",
    name=None,
):
    helper = LayerHelper("pad2d", **locals())
    out_shape = None
    if input.shape is not None:
        n, c, h, w = input.shape
        out_shape = [
            n,
            c,
            h + paddings[0] + paddings[1] if h not in (None, -1) else -1,
            w + paddings[2] + paddings[3] if w not in (None, -1) else -1,
        ]
    return _layer(
        "pad2d",
        {"X": input},
        {
            "paddings": list(paddings),
            "mode": mode,
            "pad_value": float(pad_value),
            "data_format": data_format,
        },
        out_shape=out_shape,
    )


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _layer(
        "pad_constant_like",
        {"X": x, "Y": y},
        {"pad_value": float(pad_value)},
        out_shape=x.shape,
    )


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", **locals())
    if isinstance(shape, Variable):
        inputs = {"X": x, "Y": shape}
        attrs = {"offsets": list(offsets or [])}
        out_shape = shape.shape
    else:
        inputs = {"X": x}
        attrs = {"shape": list(shape), "offsets": list(offsets or [0] * len(shape))}
        out_shape = shape
    return _layer("crop", inputs, attrs, out_shape=out_shape)


def crop_tensor(x, shape=None, offsets=None, name=None):
    return crop(x, shape, offsets, name)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    out = _layer("label_smooth", inputs, {"epsilon": float(epsilon)},
                 out_shape=label.shape)
    if dtype not in (None, out.dtype):
        from . import tensor as _tensor
        out = _tensor.cast(out, dtype)
    return out


def image_resize(
    input,
    out_shape=None,
    scale=None,
    name=None,
    resample="BILINEAR",
    actual_shape=None,
    align_corners=True,
    align_mode=1,
    data_format="NCHW",
):
    op_type = {
        "BILINEAR": "bilinear_interp",
        "NEAREST": "nearest_interp",
        "TRILINEAR": "trilinear_interp",
    }[resample.upper()]
    helper = LayerHelper(op_type, **locals())
    attrs = {
        "align_corners": align_corners,
        "align_mode": align_mode,
    }
    channel_last = data_format in ("NHWC", "NDHWC")
    if not channel_last and data_format not in ("NCHW", "NCDHW"):
        raise ValueError(
            "image_resize: data_format must be NCHW/NHWC (or NCDHW/NDHWC "
            "for trilinear), got %r" % (data_format,)
        )
    if channel_last:
        # the interp lowerings are channel-first; wrap with transposes
        nd = len(input.shape)
        to_cf = [0, nd - 1] + list(range(1, nd - 1))
        to_cl = [0] + list(range(2, nd)) + [1]
        input = transpose(input, to_cf)
    oshape = None
    if out_shape is not None:
        if op_type == "trilinear_interp":
            attrs["out_d"], attrs["out_h"], attrs["out_w"] = out_shape
            oshape = tuple(list(input.shape[:2]) + list(out_shape))
        else:
            attrs["out_h"], attrs["out_w"] = out_shape
            oshape = tuple(list(input.shape[:2]) + list(out_shape))
    elif scale is not None:
        attrs["scale"] = float(scale)
        if input.shape is not None:
            oshape = tuple(
                list(input.shape[:2])
                + [int(s * scale) if s not in (None, -1) else -1 for s in input.shape[2:]]
            )
    out = _layer(op_type, {"X": input}, attrs, out_shape=oshape)
    if channel_last:
        out = transpose(out, to_cl)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode, data_format)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True, data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners,
                        data_format=data_format)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    return image_resize(input, out_shape, scale, name, "TRILINEAR",
                        actual_shape, align_corners, align_mode,
                        data_format=data_format)


def where(condition, x=None, y=None):
    if x is None and y is None:
        helper = LayerHelper("where_index", condition=condition)
        out = helper.create_variable_for_type_inference("int64", True)
        helper.append_op(
            type="where_index",
            inputs={"Condition": [condition]},
            outputs={"Out": [out]},
        )
        return out
    return _layer(
        "where", {"Condition": condition, "X": x, "Y": y}, out_shape=x.shape
    )


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth", **locals())
    out_shape = None
    if x.shape is not None:
        n, c, h, w = x.shape
        out_shape = [n, c * blocksize * blocksize, h // blocksize, w // blocksize]
    return _layer(
        "space_to_depth", {"X": x}, {"blocksize": blocksize},
        out_shape=out_shape,
    )


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", **locals())
    out = _layer(
        "affine_channel",
        {"X": x, "Scale": scale, "Bias": bias},
        {"data_layout": data_layout},
        out_shape=x.shape,
        helper=helper,
    )
    return helper.append_activation(out)


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and grid.shape is not None:
        out.shape = (x.shape[0], x.shape[1], grid.shape[1], grid.shape[2])
    helper.append_op(
        type="grid_sampler",
        inputs={"X": [x], "Grid": [grid]},
        outputs={"Output": [out]},
    )
    return out


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", **locals())
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs = {"Theta": [theta]}
    attrs = {}
    if isinstance(out_shape, Variable):
        inputs["OutputShape"] = [out_shape]
    else:
        attrs["output_shape"] = list(out_shape)
        out.shape = (out_shape[0], out_shape[2], out_shape[3], 2)
    helper.append_op(
        type="affine_grid",
        inputs=inputs,
        outputs={"Output": [out]},
        attrs=attrs,
    )
    return out


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle", **locals())
    out_shape = None
    if x.shape is not None:
        n, c, h, w = x.shape
        r = upscale_factor
        out_shape = [n, c // (r * r), h * r, w * r]
    return _layer(
        "pixel_shuffle", {"X": x}, {"upscale_factor": upscale_factor},
        out_shape=out_shape,
    )


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _layer(
        "temporal_shift",
        {"X": x},
        {"seg_num": seg_num, "shift_ratio": shift_ratio},
        out_shape=x.shape,
    )


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", inputs=inputs, index=index)
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    out.shape = inputs[0].shape
    helper.append_op(
        type="multiplex",
        inputs={"X": list(inputs), "Ids": [index]},
        outputs={"Out": [out]},
    )
    return out


def unique(x, dtype="int32"):
    raise NotImplementedError(
        "unique has data-dependent output shape; not representable in a "
        "static-shape program. Use it host-side via numpy."
    )


def unique_with_counts(x, dtype="int32"):
    raise NotImplementedError(
        "unique_with_counts has data-dependent output shape; use host-side "
        "numpy instead."
    )


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    helper = LayerHelper("im2sequence", **locals())
    fs = _pair(filter_size)
    st = _pair(stride)
    pd = [padding] * 4 if isinstance(padding, int) else list(padding)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"kernels": fs, "strides": st, "paddings": pd},
    )
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the SHORTER spatial edge equals out_short_len, keeping
    aspect ratio (ref nn.py image_resize_short). Needs static H/W."""
    h, w = input.shape[2], input.shape[3]
    if h in (None, -1) or w in (None, -1):
        raise ValueError(
            "image_resize_short needs static spatial dims (shapes are "
            "fixed when the program is built)"
        )
    if h < w:
        out_shape = [out_short_len, int(round(w * out_short_len / h))]
    else:
        out_shape = [int(round(h * out_short_len / w)), out_short_len]
    return image_resize(input, out_shape=out_shape, resample=resample)


def similarity_focus(input, axis, indexes, name=None):
    """Similarity focus mask (ref nn.py similarity_focus): greedy
    distinct-row/col maxima of the selected channel slices, broadcast
    over the focus axis."""
    helper = LayerHelper("similarity_focus", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="similarity_focus",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axis": axis, "indexes": list(indexes)},
    )
    return out


def merge_selected_rows(x, name=None):
    """SelectedRows row merge (ref nn.py merge_selected_rows). Gradients
    here are dense tensors (the embedding backward sums duplicate rows
    already), so this is an identity kept for script compatibility."""
    helper = LayerHelper("merge_selected_rows", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="merge_selected_rows", inputs={"X": [x]},
        outputs={"Out": [out]},
    )
    return out


def get_tensor_from_selected_rows(x, name=None):
    """SelectedRows -> dense (ref nn.py): dense already; identity."""
    helper = LayerHelper("get_tensor_from_selected_rows", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="get_tensor_from_selected_rows", inputs={"X": [x]},
        outputs={"Out": [out]},
    )
    return out


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=[1, 1],
                           pooled_height=1, pooled_width=1,
                           part_size=None, sample_per_part=1,
                           trans_std=0.1, position_sensitive=False,
                           name=None):
    """Deformable (PS-)ROI pooling (ref nn.py deformable_roi_pooling):
    bins sample at learned normalized offsets; position_sensitive selects
    the psroi channel layout."""
    helper = LayerHelper("deformable_roi_pooling", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    part_size = part_size or [pooled_height, pooled_width]
    if position_sensitive:
        gh = group_size[0] if isinstance(group_size, (list, tuple)) \
            else group_size
        gw = group_size[1] if isinstance(group_size, (list, tuple)) \
            else group_size
        out_dim = input.shape[1] // (gh * gw)
    else:
        out_dim = input.shape[1]
    if rois.shape is not None:
        out.shape = (rois.shape[0], out_dim, pooled_height, pooled_width)
    ins = {"Input": [input], "ROIs": [rois]}
    if not no_trans and trans is not None:
        ins["Trans"] = [trans]
    helper.append_op(
        type="deformable_psroi_pooling",
        inputs=ins,
        outputs={"Output": [out]},
        attrs={
            "no_trans": no_trans,
            "spatial_scale": spatial_scale,
            "output_dim": out_dim,
            "group_size": list(group_size)
            if isinstance(group_size, (list, tuple)) else [group_size] * 2,
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "part_size": list(part_size),
            "sample_per_part": sample_per_part,
            "trans_std": trans_std,
            "position_sensitive": position_sensitive,
        },
    )
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Tree-based convolution (TBCNN; ref operators/tree_conv_op.h, used
    by dygraph TreeConv ref dygraph/nn.py:2970). nodes_vector (B, N, F),
    edge_set (B, E, 2) int32 1-indexed (parent, child); returns
    (B, N, output_size, num_filters)."""
    helper = LayerHelper("tree_conv", **locals())
    dtype = helper.input_dtype("nodes_vector")
    f = nodes_vector.shape[-1]
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[f, 3, output_size, num_filters],
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)
    if nodes_vector.shape is not None:
        out.shape = (nodes_vector.shape[0], nodes_vector.shape[1],
                     output_size, num_filters)
    helper.append_op(
        type="tree_conv",
        inputs={"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                "Filter": [w]},
        outputs={"Out": [out]},
        attrs={"max_depth": max_depth},
    )
    pre_act = helper.append_bias_op(out, dim_start=3, dim_end=4)
    return helper.append_activation(pre_act)


_PY_FUNC_REGISTRY = {}


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Custom python op (ref nn.py:12191 py_func): the step copies the
    inputs to host numpy, calls `func` and copies the returned arrays back
    (static shapes from the pre-declared `out` vars; -1 dims resolve to
    the first input's batch dim). backward_func(x..., out..., dout...)
    supplies the gradient; functions live in a process-local registry, so
    programs using py_func serialize structurally but need the functions
    re-registered after deserialization."""
    helper = LayerHelper("py_func", **locals())
    xs = [x] if isinstance(x, Variable) else list(x)
    outs = [out] if isinstance(out, Variable) else list(out)
    for o in outs:
        if o.shape is None:
            raise ValueError(
                "py_func out var '%s' needs a declared shape (the "
                "callback's result buffer is pre-allocated)" % o.name
            )
    skip = set()
    for v in (skip_vars_in_backward_input or []):
        skip.add(v.name if isinstance(v, Variable) else str(v))
    func_id = len(_PY_FUNC_REGISTRY)
    _PY_FUNC_REGISTRY[func_id] = (func, backward_func, skip)
    helper.append_op(
        type="py_func",
        inputs={"X": xs},
        outputs={"Out": outs},
        attrs={
            "func_id": func_id,
            "out_shapes": [list(o.shape) for o in outs],
            "out_dtypes": [str(o.dtype) for o in outs],
            "x_names": [v.name for v in xs],
            "out_names": [o.name for o in outs],
        },
    )
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]],
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="row_conv",
        inputs={"X": [input], "Filter": [w]},
        outputs={"Out": [out]},
    )
    return helper.append_activation(out)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="shard_index",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "index_num": index_num,
            "nshards": nshards,
            "shard_id": shard_id,
            "ignore_value": ignore_value,
        },
    )
    return out


def hash(input, hash_size, num_hash=1, name=None):
    helper = LayerHelper("hash", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hash",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"mod_by": hash_size, "num_hash": num_hash},
    )
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="unfold",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={
            "kernel_sizes": _pair(kernel_sizes),
            "strides": _pair(strides),
            "paddings": _pair(paddings),
            "dilations": _pair(dilations),
        },
    )
    return out


def shuffle_channel(x, group, name=None):
    return _layer("shuffle_channel", {"X": x}, {"group": group},
                  out_shape=x.shape)


def add_position_encoding(input, alpha, beta, name=None):
    return _layer(
        "add_position_encoding",
        {"X": input},
        {"alpha": alpha, "beta": beta},
        out_shape=input.shape,
    )


def continuous_value_model(input, cvm, use_cvm=True):
    helper = LayerHelper("cvm", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cvm",
        inputs={"X": [input], "CVM": [cvm]},
        outputs={"Y": [out]},
        attrs={"use_cvm": use_cvm},
    )
    return out


def fsp_matrix(x, y):
    helper = LayerHelper("fsp_matrix", x=x, y=y)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (x.shape[0], x.shape[1], y.shape[1])
    helper.append_op(
        type="fsp", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}
    )
    return out


def filter_by_instag(ins, ins_tag, filter_tag, is_lod):
    raise NotImplementedError(
        "filter_by_instag produces data-dependent shapes; filter host-side"
    )


def uniform_random_batch_size_like(
    input,
    shape,
    dtype="float32",
    input_dim_idx=0,
    output_dim_idx=0,
    min=-1.0,
    max=1.0,
    seed=0,
):
    helper = LayerHelper("uniform_random_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
            "min": min,
            "max": max,
            "seed": seed,
            "dtype": core.convert_dtype(dtype),
        },
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type="gaussian_random",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "mean": mean,
            "std": std,
            "seed": seed,
            "dtype": core.convert_dtype(dtype),
        },
    )
    return out


def gaussian_random_batch_size_like(
    input,
    shape,
    input_dim_idx=0,
    output_dim_idx=0,
    mean=0.0,
    std=1.0,
    seed=0,
    dtype="float32",
):
    helper = LayerHelper("gaussian_random_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
            "mean": mean,
            "std": std,
            "seed": seed,
            "dtype": core.convert_dtype(dtype),
        },
    )
    return out


# The reference's nn.py __all__ also exports these; here they are defined in
# sibling modules (sequence_lod/rnn/ops) and re-exported for parity
# (ref nn.py:84,85,184,185).
from .sequence_lod import lod_reset, lod_append  # noqa: E402
from .rnn import gather_tree  # noqa: E402

__all__ += ["lod_reset", "lod_append", "gather_tree", "uniform_random"]


def __getattr__(name):
    # uniform_random lives in ops.py, which itself imports from this
    # module at its top — resolve lazily so neither import order works
    # only by accident (PEP 562)
    if name == "uniform_random":
        from .ops import uniform_random

        return uniform_random
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
