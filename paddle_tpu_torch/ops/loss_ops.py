"""Loss op lowering: softmax_with_cross_entropy (ref: paddle/fluid/
operators/softmax_with_cross_entropy_op.cc). Port of the paddle_tpu/ops/
loss_ops.py lowering BERT's pretraining head runs: log-softmax over
``axis``, soft labels over any axis, hard labels with ``ignore_index``
(those rows give loss 0) over the last axis, and the Softmax side output."""
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
    soft = attrs.get("soft_label", False)
    last = axis in (-1, logits.dim() - 1)
    if not soft and not last:
        # The reference gathers with lab[..., None] along `axis`: a label
        # shaped (N, 1, T) makes take_along_axis raise, and one shaped
        # (N, T) picks logp[n, lab[n, t], 0] for every t. Neither is the op.
        raise NotImplementedError(
            "softmax_with_cross_entropy with hard labels over axis %d: the "
            "reference's lowering (paddle_tpu/ops/loss_ops.py) does not "
            "compute it either (its gather over a non-last axis fails or "
            "picks the wrong elements); use the last axis or soft labels"
            % axis)
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if soft:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        ignore = attrs.get("ignore_index", -100)
        lab = _squeeze_label(label).long()
        picked = logp.gather(
            -1, lab.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        loss = (-picked).masked_fill(lab == ignore, 0.0)[..., None]
    return {"Softmax": [softmax], "Loss": [loss]}
