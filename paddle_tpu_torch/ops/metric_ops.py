"""Metric op lowering: accuracy (ref: paddle/fluid/operators/metrics/
accuracy_op.cc). Port of the paddle_tpu/ops/metric_ops.py lowering."""
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
