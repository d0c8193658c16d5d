"""Metric op lowerings: accuracy, auc, mean_iou and precision_recall (ref:
paddle/fluid/operators/metrics/accuracy_op.cc, auc_op.cc,
mean_iou_op.cc, precision_recall_op.cc). Port of the paddle_tpu/ops/
metric_ops.py lowerings."""
import torch

from .loss_ops import scatter_add
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


@register_op("mean_iou")
def _mean_iou(ctx, ins, attrs):
    """Mean intersection over union of ``num_classes`` classes from the
    confusion matrix cm[label, pred], counted by a scatter-add at label·n
    + pred with jax's rule (a negative index counts from the end once, one
    still out of range is dropped). The mean is over classes with a
    nonzero union. OutWrong and OutCorrect are int32, as the reference
    declares them."""
    n = attrs["num_classes"]
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    cm = scatter_add(n * n, label * n + pred, 1.0).reshape(n, n)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    miou = iou.sum() / torch.clamp(valid.sum(), min=1)
    return {"OutMeanIou": [miou],
            "OutWrong": [(cm.sum(1) - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Per-class precision, recall and F1 of one batch (the top-1 Indices
    against Labels), their macro means as BatchMetrics and AccumMetrics
    (the reference keeps no state across batches), and AccumStatesInfo
    [TP, FP, FN] a class; counts by scatter-adds with jax's index rule."""
    idx = ins["Indices"][0][:, 0].long()
    label = ins["Labels"][0]
    if label.dim() == 2:
        label = label[:, 0]
    label = label.long()
    n = attrs["class_number"]
    tp = scatter_add(n, label, (idx == label).to(torch.float32))
    pred_cnt = scatter_add(n, idx, 1.0)
    lab_cnt = scatter_add(n, label, 1.0)
    precision = tp / torch.clamp(pred_cnt, min=1.0)
    recall = tp / torch.clamp(lab_cnt, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-6)
    means = torch.stack([precision.mean(), recall.mean(), f1.mean()])
    metrics = torch.cat([means, means])
    return {"BatchMetrics": [metrics], "AccumMetrics": [metrics],
            "AccumStatesInfo": [torch.stack(
                [tp, pred_cnt - tp, lab_cnt - tp], dim=1)]}
