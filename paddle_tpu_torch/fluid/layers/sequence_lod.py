"""Sequence layers (ref: python/paddle/fluid/layers/sequence_lod.py);
port of paddle_tpu/fluid/layers/sequence_lod.py, which builds Programs
without jax: the same ops, attrs and var names.

A lod_level>0 var `x` travels as a dense-padded (B, T, ...) tensor plus a
companion `x@SEQ_LEN` int32 vector (created by fluid.data, fed from
LoDTensor feeds: fluid/executor.py ``expand_lod_feeds``). Sequence layers
wire the companion into the op's SeqLen slot and propagate it to their
outputs where the sequence structure is preserved.
"""
import numpy as np

from ..layer_helper import LayerHelper
from ..framework import Variable

__all__ = [
    "sequence_conv", "sequence_softmax", "sequence_pool", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate", "sequence_mask", "sequence_reverse",
    "lod_reset", "lod_append",
]


def _seq_len_var(x):
    """Find x's companion length var, walking producer aliases."""
    block = x.block
    name = x.name + "@SEQ_LEN"
    if block.has_var_recursive(name):
        return block._var_recursive(name)
    return None


def _alias_seq_len(helper, src, dst):
    """Propagate sequence lengths: dst@SEQ_LEN = src@SEQ_LEN."""
    sl = _seq_len_var(src)
    if sl is None:
        return
    block = dst.block
    out = block.create_var(
        name=dst.name + "@SEQ_LEN", shape=sl.shape, dtype=sl.dtype,
        stop_gradient=True,
    )
    helper.append_op(
        type="assign", inputs={"X": [sl]}, outputs={"Out": [out]}
    )


def _seq_inputs(x):
    ins = {"X": [x]}
    sl = _seq_len_var(x)
    if sl is not None:
        ins["SeqLen"] = [sl]
    return ins


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference("int32", True)
    if input.shape is not None:
        out.shape = (input.shape[0],) + tuple(input.shape[2:])
    helper.append_op(
        type="sequence_pool",
        inputs=_seq_inputs(input),
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "pad_value": pad_value},
    )
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="sequence_softmax",
        inputs=_seq_inputs(input),
        outputs={"Out": [out]},
    )
    _alias_seq_len(helper, input, out)
    return out


def sequence_conv(
    input,
    num_filters,
    filter_size=3,
    filter_stride=1,
    padding=True,
    padding_start=None,
    bias_attr=None,
    param_attr=None,
    act=None,
    name=None,
):
    if filter_stride != 1:
        # same restriction as the reference (sequence_lod.py:106:
        # "Currently only supports stride = 1")
        raise ValueError("sequence_conv only supports filter_stride=1")
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[filter_size * input.shape[-1], num_filters],
        dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (num_filters,)
    ins = _seq_inputs(input)
    ins["Filter"] = [w]
    helper.append_op(
        type="sequence_conv",
        inputs=ins,
        outputs={"Out": [out]},
        attrs={
            "contextStride": filter_stride,
            "contextStart": padding_start
            if padding_start is not None
            else -(filter_size // 2),
            "contextLength": filter_size,
        },
    )
    _alias_seq_len(helper, input, out)
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    ins = {"X": list(input)}
    lens = [_seq_len_var(x) for x in input]
    if all(l is not None for l in lens):
        ins["SeqLen"] = lens
        # out lengths = sum of the inputs' lengths
        block = out.block
        new_len = block.create_var(
            name=out.name + "@SEQ_LEN", shape=lens[0].shape,
            dtype=lens[0].dtype, stop_gradient=True,
        )
        helper.append_op(
            type="sum", inputs={"X": lens}, outputs={"Out": [new_len]}
        )
    helper.append_op(
        type="sequence_concat", inputs=ins, outputs={"Out": [out]}
    )
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"ref_level": ref_level},
    )
    _alias_seq_len(helper, y, out)
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand_as",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    _alias_seq_len(helper, y, out)
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64", True)
    ins = _seq_inputs(x)
    if isinstance(pad_value, Variable):
        ins["PadValue"] = [pad_value]
    helper.append_op(
        type="sequence_pad",
        inputs=ins,
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": maxlen if maxlen else -1},
    )
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="sequence_unpad",
        inputs={"X": [x], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"new_dim": new_dim},
    )
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
    )
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]},
    )
    # out lengths = requested slice lengths
    new_len = out.block.create_var(
        name=out.name + "@SEQ_LEN", shape=(-1,), dtype="int32",
        stop_gradient=True,
    )
    helper.append_op(
        type="cast",
        inputs={"X": [length]},
        outputs={"Out": [new_len]},
        attrs={"in_dtype": length.dtype, "out_dtype": "int32"},
    )
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_enumerate",
        inputs=_seq_inputs(input),
        outputs={"Out": [out]},
        attrs={"win_size": win_size, "pad_value": pad_value},
    )
    _alias_seq_len(helper, input, out)
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    ins = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if isinstance(maxlen, Variable):
        ins["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = maxlen if maxlen is not None else -1
    if x.shape is not None and attrs["maxlen"] not in (None, -1):
        out.shape = (x.shape[0], attrs["maxlen"])
    helper.append_op(
        type="sequence_mask", inputs=ins, outputs={"Y": [out]}, attrs=attrs
    )
    return out


def lod_reset(x, y=None, target_lod=None):
    """Replace x's sequence structure (ref layers/nn.py lod_reset). In the
    dense-padded rep this swaps the `@SEQ_LEN` companion: from y's when y
    is a lod-carrying Variable, from y's int values when y is a plain
    1-D int Variable, or from the target_lod python list (length form,
    like the reference's recursive_seq_lens). The payload tensor is
    passed through unchanged — re-bucketing flat tokens into a different
    padding layout is a host-side reshape in this design."""
    from . import tensor as tensor_layers

    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="assign", inputs={"X": [x]}, outputs={"Out": [out]}
    )
    if isinstance(y, Variable):
        src_sl = _seq_len_var(y)
        if src_sl is None:
            # y IS the lengths vector
            src_sl = y
        block = out.block
        sl_out = block.create_var(
            name=out.name + "@SEQ_LEN", shape=src_sl.shape,
            dtype="int32", stop_gradient=True,
        )
        helper.append_op(
            type="cast", inputs={"X": [src_sl]}, outputs={"Out": [sl_out]},
            attrs={"in_dtype": src_sl.dtype, "out_dtype": "int32"},
        )
    elif target_lod is not None:
        lens = tensor_layers.assign(
            np.asarray(list(target_lod), dtype="int32")
        )
        block = out.block
        sl_out = block.create_var(
            name=out.name + "@SEQ_LEN", shape=(len(list(target_lod)),),
            dtype="int32", stop_gradient=True,
        )
        helper.append_op(
            type="assign", inputs={"X": [lens]}, outputs={"Out": [sl_out]}
        )
    else:
        raise ValueError("lod_reset needs y or target_lod")
    return out


def lod_append(x, level):
    """Append a LoD level (ref layers/nn.py lod_append). Only the deepest
    level is materialized in the dense rep (see fluid/lod.py), so this
    replaces the companion lengths with `level` — same observable
    behavior for every sequence op, which only reads the deepest level."""
    if level is None:
        raise ValueError("lod_append needs a non-None level")
    if isinstance(level, (list, tuple)):
        return lod_reset(x, target_lod=list(level))
    return lod_reset(x, y=level)


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="sequence_reverse",
        inputs=_seq_inputs(x),
        outputs={"Y": [out]},
    )
    _alias_seq_len(helper, x, out)
    return out
