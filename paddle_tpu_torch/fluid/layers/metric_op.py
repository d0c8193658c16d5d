"""Metric layers (ref: python/paddle/fluid/layers/metric_op.py); port of
paddle_tpu/fluid/layers/metric_op.py."""
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy", **locals())
    from .nn import topk

    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    acc_out.shape = ()
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", True)
    if total is None:
        total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        type="accuracy",
        inputs={
            "Out": [topk_out],
            "Indices": [topk_indices],
            "Label": [label],
        },
        outputs={
            "Accuracy": [acc_out],
            "Correct": [correct],
            "Total": [total],
        },
    )
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=2**12 - 1, topk=1,
        slide_steps=1):
    """Streaming AUC: two non-trainable persistable statistics of
    num_thresholds + 1 bins, updated every run. Returns
    ``(auc_out, [stat_pos, stat_neg])``."""
    helper = LayerHelper("auc", **locals())
    stat_pos = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(0.0), trainable=False),
        shape=[num_thresholds + 1],
        dtype="float32",
    )
    stat_pos.stop_gradient = True
    stat_neg = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(0.0), trainable=False),
        shape=[num_thresholds + 1],
        dtype="float32",
    )
    stat_neg.stop_gradient = True
    auc_out = helper.create_variable_for_type_inference("float64")
    auc_out.shape = ()
    helper.append_op(
        type="auc",
        inputs={
            "Predict": [input],
            "Label": [label],
            "StatPos": [stat_pos],
            "StatNeg": [stat_neg],
        },
        outputs={
            "AUC": [auc_out],
            "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg],
        },
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out, [stat_pos, stat_neg]
