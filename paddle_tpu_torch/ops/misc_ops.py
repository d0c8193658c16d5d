"""Misc op lowerings: nce (ref: paddle/fluid/operators/nce_op.cc) and
hierarchical_sigmoid (hierarchical_sigmoid_op.cc), the two loss ops of
paddle_tpu/ops/misc_ops.py that fluid/layers/loss.py builds on. The other
op types of that file come in a later slice (ROADMAP.md Queue 1, item
6.7)."""
import numpy as np
import torch

from .detection_ops import scalar
from .loss_ops import _f32_log, gather_rows, uniform_samples
from .nn_ops import jax_softplus
from .registry import register_op


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform negatives, as the
    reference computes it: ``num_neg_samples`` class ids drawn from the
    run's generator (one set for the batch); the true class's logit x·w
    (+ b) and the negatives' x·wᵀ (+ b), each less log(num_neg / classes);
    Cost = softplus(-true) + the sum of softplus(negatives), (B, 1). The
    first label column is the true class (a label out of range clamps, as
    jax's gather does)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    num_neg = attrs.get("num_neg_samples", 10)
    n_classes = attrs["num_total_classes"]
    lab = ins["Label"][0]
    if lab.dim() == 1:
        lab = lab[:, None]
    neg = uniform_samples(ctx, num_neg, n_classes, x.device)
    true_logit = (x * gather_rows(w, lab[:, 0])).sum(dim=-1)
    if b is not None:
        true_logit = true_logit + gather_rows(b, lab[:, 0])[:, 0]
    neg_logit = x @ w[neg].T
    if b is not None:
        neg_logit = neg_logit + b[neg, 0][None, :]
    logq = _f32_log(num_neg / n_classes)
    cost = jax_softplus(-(true_logit - logq)) + jax_softplus(
        neg_logit - logq).sum(dim=-1)
    return {"Cost": [cost[:, None]]}


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """The default complete binary tree's hierarchical sigmoid: the leaf of
    label l sits at heap position l + C (1-indexed); for each of the
    ceil(log2 C) levels the internal node (position >> d) - 1 (clipped to
    W's rows) scores x·w (+ b), and softplus(∓logit) by the direction bit
    (position >> (d - 1)) & 1 adds to the loss where the node exists.
    The shifts run on int64."""
    x, w = ins["X"][0], ins["W"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    num_classes = attrs["num_classes"]
    depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    lab = ins["Label"][0].long()
    if lab.dim() == 2:
        lab = lab[:, 0]
    code = lab + num_classes
    zero = scalar(0.0, x)
    loss = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for d in range(depth, 0, -1):
        parent = code >> d
        bit = (code >> (d - 1)) & 1
        nid = (parent - 1).clamp(0, w.shape[0] - 1)
        logit = (x * w[nid]).sum(dim=-1)
        if b is not None:
            logit = logit + b[nid, 0]
        step = jax_softplus(torch.where(bit == 1, -logit, logit))
        loss = loss + torch.where(parent >= 1, step, zero)
    return {"Out": [loss[:, None]]}
