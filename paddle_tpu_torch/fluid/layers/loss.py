"""Loss layers (ref: python/paddle/fluid/layers/loss.py); port of
paddle_tpu/fluid/layers/loss.py. ``square_error_cost``, ``kldiv_loss``,
``npair_loss``, ``mse_loss`` and ``cross_entropy`` live in nn.py and are
re-exported here, as in the reference."""
from ..layer_helper import LayerHelper
from .nn import _layer

__all__ = [
    "center_loss", "bpr_loss", "cross_entropy", "cross_entropy2",
    "square_error_cost", "edit_distance", "nce", "hsigmoid",
    "sampled_softmax_with_cross_entropy", "softmax_with_cross_entropy",
    "rank_loss", "margin_rank_loss", "sigmoid_cross_entropy_with_logits",
    "teacher_student_sigmoid_loss", "huber_loss", "kldiv_loss", "npair_loss",
    "mse_loss", "warpctc",
]

from .nn import cross_entropy, kldiv_loss, mse_loss, npair_loss, square_error_cost  # noqa: F401,E402


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    numeric_stable_mode=True,
    return_softmax=False,
    axis=-1,
):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax.shape = logits.shape
    if logits.shape is not None:
        s = list(logits.shape)
        s[axis] = 1
        loss.shape = tuple(s)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={
            "soft_label": soft_label,
            "ignore_index": ignore_index,
            "numeric_stable_mode": numeric_stable_mode,
            "axis": axis,
        },
    )
    if return_softmax:
        return loss, softmax
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    out.shape = input.shape
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out], "Residual": [residual]},
        attrs={"delta": delta},
    )
    return out


def sigmoid_cross_entropy_with_logits(
    x, label, ignore_index=-100, name=None, normalize=False
):
    return _layer(
        "sigmoid_cross_entropy_with_logits",
        {"X": x, "Label": label},
        {"ignore_index": ignore_index, "normalize": normalize},
        out_shape=x.shape,
    )


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    helper = LayerHelper("center_loss", **locals())
    dtype = helper.input_dtype()
    from ..initializer import Constant
    from ..param_attr import ParamAttr
    from . import tensor as t

    centers = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(0.0), trainable=False),
        shape=[num_classes, input.shape[1]],
        dtype=dtype,
    )
    centers.stop_gradient = True
    loss = helper.create_variable_for_type_inference(dtype)
    diff = helper.create_variable_for_type_inference(dtype, True)
    loss.shape = (input.shape[0], 1)
    alpha_var = t.fill_constant([1], dtype, alpha)
    helper.append_op(
        type="center_loss",
        inputs={
            "X": [input],
            "Label": [label],
            "Centers": [centers],
            "CenterUpdateRate": [alpha_var],
        },
        outputs={
            "Loss": [loss],
            "SampleCenterDiff": [diff],
            "CentersOut": [centers],
        },
        attrs={"need_update": update_center},
    )
    return loss


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (input.shape[0], 1)
    helper.append_op(
        type="bpr_loss",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
    )
    return out


def rank_loss(label, left, right, name=None):
    return _layer(
        "rank_loss",
        {"Label": label, "Left": left, "Right": right},
        out_shape=label.shape,
    )


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", **locals())
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    out.shape = label.shape
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label], "X1": [left], "X2": [right]},
        outputs={"Out": [out], "Activated": [act]},
        attrs={"margin": margin},
    )
    return out


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper("teacher_student_sigmoid_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="teacher_student_sigmoid_loss",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={
            "soft_max_up_bound": soft_max_up_bound,
            "soft_max_lower_bound": soft_max_lower_bound,
        },
    )
    return out


def sampled_softmax_with_cross_entropy(
    logits,
    label,
    num_samples,
    num_true=1,
    remove_accidental_hits=True,
    use_customized_samples=False,
    customized_samples=None,
    customized_probabilities=None,
    seed=0,
):
    helper = LayerHelper("sampled_softmax_with_cross_entropy", **locals())
    loss = helper.create_variable_for_type_inference(logits.dtype)
    loss.shape = (logits.shape[0], 1)
    helper.append_op(
        type="sampled_softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Loss": [loss]},
        attrs={
            "num_samples": num_samples,
            "num_true": num_true,
            "remove_accidental_hits": remove_accidental_hits,
            "seed": seed,
        },
    )
    return loss


def nce(
    input,
    label,
    num_total_classes,
    sample_weight=None,
    param_attr=None,
    bias_attr=None,
    num_neg_samples=None,
    name=None,
    sampler="uniform",
    custom_dist=None,
    seed=0,
    is_sparse=False,
):
    """Noise-contrastive estimation (ref loss.py nce): uniform negatives
    drawn by the op from the run's generator."""
    helper = LayerHelper("nce", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[1]
    num_neg = num_neg_samples or 10
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, dim], dtype=dtype
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_total_classes, 1], dtype=dtype,
        is_bias=True,
    )
    cost = helper.create_variable_for_type_inference(dtype)
    cost.shape = (input.shape[0], 1)
    helper.append_op(
        type="nce",
        inputs={"Input": [input], "Label": [label], "Weight": [w],
                "Bias": [b]},
        outputs={"Cost": [cost]},
        attrs={
            "num_total_classes": num_total_classes,
            "num_neg_samples": num_neg,
            "seed": seed,
        },
    )
    return cost


def hsigmoid(
    input,
    label,
    num_classes,
    param_attr=None,
    bias_attr=None,
    name=None,
    path_table=None,
    path_code=None,
    is_custom=False,
    is_sparse=False,
):
    """Hierarchical sigmoid over the default complete binary tree (ref
    loss.py hsigmoid)."""
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[1]
    num_nodes = num_classes - 1
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_nodes, dim], dtype=dtype
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_nodes, 1], dtype=dtype, is_bias=True
    )
    cost = helper.create_variable_for_type_inference(dtype)
    cost.shape = (input.shape[0], 1)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs={"X": [input], "Label": [label], "W": [w], "Bias": [b]},
        outputs={"Out": [cost]},
        attrs={"num_classes": num_classes},
    )
    return cost


def cross_entropy2(input, label, ignore_index=-100):
    """Hard-label cross entropy over probabilities (ref loss.py:253
    cross_entropy2 op): -log(input[label]), 0 where label == ignore_index."""
    helper = LayerHelper("cross_entropy2", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    match_x = helper.create_variable_for_type_inference(input.dtype, True)
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (1,)
    helper.append_op(
        type="cross_entropy2",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out], "MatchX": [match_x], "XShape": [xshape]},
        attrs={"ignore_index": ignore_index},
    )
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance (ref loss.py:340). Sequences travel dense
    padded (B, T) with explicit length vectors (the LoD companion is used
    when lengths aren't passed). Returns (distance (B, 1), sequence_num)."""
    from .sequence_lod import _seq_len_var

    helper = LayerHelper("edit_distance", **locals())
    if ignored_tokens:
        raise NotImplementedError(
            "edit_distance ignored_tokens: filter tokens host-side (or via "
            "ctc_greedy_decoder's compaction) before this op — dense "
            "removal changes sequence lengths"
        )
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64", True)
    ins = {"Hyps": [input], "Refs": [label]}
    in_len = input_length if input_length is not None \
        else _seq_len_var(input)
    lab_len = label_length if label_length is not None \
        else _seq_len_var(label)
    if in_len is not None:
        ins["HypsLength"] = [in_len]
    if lab_len is not None:
        ins["RefsLength"] = [lab_len]
    if input.shape is not None:
        out.shape = (input.shape[0], 1)
    helper.append_op(
        type="edit_distance",
        inputs=ins,
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized},
    )
    return out, seq_num


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss (ref loss.py warpctc → warp-ctc kernel): the dense
    log-domain forward algorithm of the warpctc lowering. Logits and
    labels travel padded: input (B, T, C), label (B, L) padded with
    `blank`; ``norm_by_times`` is recorded and not read."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc",
        inputs=inputs,
        outputs={"Loss": [loss]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss
