"""Loss op lowering: softmax_with_cross_entropy (ref: paddle/fluid/
operators/softmax_with_cross_entropy_op.cc). Port of the paddle_tpu/ops/
loss_ops.py lowering BERT's pretraining head runs: log-softmax over the
last axis, hard labels with ``ignore_index`` (those rows give loss 0) or
soft labels, and the Softmax side output."""
import torch

from .registry import register_op


def _squeeze_label(label):
    if label.dim() >= 2 and label.shape[-1] == 1:
        return label[..., 0]
    return label


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    if axis not in (-1, logits.dim() - 1):
        raise NotImplementedError(
            "softmax_with_cross_entropy over axis %d: the port takes the "
            "last axis only so far" % axis)
    logp = torch.log_softmax(logits, dim=-1)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        ignore = attrs.get("ignore_index", -100)
        lab = _squeeze_label(label).long()
        picked = logp.gather(
            -1, lab.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        loss = (-picked).masked_fill(lab == ignore, 0.0)[..., None]
    return {"Softmax": [softmax], "Loss": [loss]}
