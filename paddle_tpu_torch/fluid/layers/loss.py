"""Loss layers (ref: python/paddle/fluid/layers/loss.py); port of the
paddle_tpu/fluid/layers/loss.py functions BERT's pretraining head and
SSD's loss call."""
from ..layer_helper import LayerHelper

__all__ = ["softmax_with_cross_entropy", "huber_loss"]


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
