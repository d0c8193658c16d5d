"""Metric op lowerings: accuracy and auc (ref: paddle/fluid/operators/
metrics/accuracy_op.cc, auc_op.cc). Port of the paddle_tpu/ops/
metric_ops.py lowerings."""
import torch

from .registry import register_op


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k ``Indices``:
    Accuracy f32, Correct and Total int32, as the reference casts them."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label[:, 0]
    hit = (idx == label[:, None].to(idx.dtype)).any(dim=-1)
    correct = hit.to(torch.float32).sum()
    total = torch.tensor(float(idx.shape[0]), dtype=torch.float32,
                         device=idx.device)
    return {"Accuracy": [correct / total],
            "Correct": [correct.to(torch.int32)],
            "Total": [total.to(torch.int32)]}


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over fixed histogram bins, as the reference
    computes it: the positive-class probability (the last column of a 2-d
    Predict) binned by truncating p·num_thresholds to int32 and clipping it
    to [0, num_thresholds]; 0/1 counts scatter-added into the persistable
    StatPos and StatNeg (exact integers below 2^24 in f32, so index_add
    gives the same sums in any order); reversed cumulative sums, and the
    trapezoid rule in jnp.trapezoid's order. StatPosOut and StatNegOut name
    the statistics, so the run writes them back like batch norm's moving
    statistics. AUC is f32: the layer declares float64, which the
    reference computes in f32 without x64."""
    predict, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = attrs.get("num_thresholds", 4095)
    if label.dim() == 2:
        label = label[:, 0]
    pos_prob = predict[:, -1] if predict.dim() == 2 else predict
    bins = (pos_prob * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, bins, is_pos)
    stat_neg = stat_neg.index_add(0, bins, 1 - is_pos)
    tp = torch.cumsum(stat_pos.flip(0), 0)
    fp = torch.cumsum(stat_neg.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1.0)
    fpr = fp / torch.clamp(fp[-1], min=1.0)
    auc = 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()
    return {"AUC": [auc], "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg]}
