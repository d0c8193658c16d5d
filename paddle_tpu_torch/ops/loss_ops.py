"""Loss op lowerings: softmax_with_cross_entropy (ref: paddle/fluid/
operators/softmax_with_cross_entropy_op.cc), cross_entropy
(cross_entropy_op.cc), huber_loss (huber_loss_op.cc) and log_loss
(log_loss_op.cc).
Port of the paddle_tpu/ops/loss_ops.py lowerings. softmax_with_cross_entropy
is the one BERT's pretraining head runs: log-softmax over
``axis``, soft labels over any axis, hard labels with ``ignore_index``
(those rows give loss 0) over the last axis, and the Softmax side output.

Softmax and Loss come out in the logits' dtype, as in the reference: under
bf16 AMP the MLM logits, and so both outputs and the mean loss, are
bfloat16. For f32 logits the log-softmax is ``torch.log_softmax``. For
narrower logits it is jax's ``log_softmax``, op for op (:func:`_log_softmax`):
``torch.log_softmax`` computes in f32 and rounds once, which moved 74% of
the bfloat16 logits' gradient elements off the reference's and made the
two packages' AMP gradients differ by as much as AMP and f32 do
(tests/test_torch_amp.py)."""
import torch

from .promotion import promote
from .registry import register_op


def _log_softmax(x, axis):
    """log_softmax over `axis`. In f32 (and wider) ``torch.log_softmax``.
    In bfloat16 and float16 the reference's sequence, each op in x's dtype
    as jax computes it: shifted = x - max, logsumexp = log(sum(exp(
    shifted))) with the sum over f32 partials rounded once (on the card
    too: a 30522-wide vocabulary row sums in f32), result = shifted -
    logsumexp. Autograd then differentiates the same sequence."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.log_softmax(x, dim=axis)
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=axis, keepdim=True))


def _squeeze_label(label):
    if label.dim() >= 2 and label.shape[-1] == 1:
        return label[..., 0]
    return label


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """-log of the probability X gives the label, X read no lower than
    1e-12: hard labels over the last axis (``ignore_index`` rows give 0),
    soft labels summed. Y keeps a trailing axis of 1. The floor is
    ``torch.maximum``, whose gradient splits at a tie as jax's does."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = x.new_tensor(1e-12)
    if attrs.get("soft_label", False):
        return {"Y": [-(label * torch.log(torch.maximum(x, eps))).sum(
            dim=-1, keepdim=True)]}
    lab = _squeeze_label(label).long()
    picked = x.gather(-1, lab.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
    out = -torch.log(torch.maximum(picked, eps))
    ignore = attrs.get("ignore_index", -100)
    return {"Y": [torch.where(lab == ignore, 0.0, out)[..., None]]}


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
    logp = _log_softmax(logits, axis)
    softmax = torch.exp(logp)
    if soft:
        loss = -torch.mul(*promote(label, logp)).sum(dim=axis, keepdim=True)
    else:
        ignore = attrs.get("ignore_index", -100)
        lab = _squeeze_label(label).long()
        picked = logp.gather(
            -1, lab.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        loss = (-picked).masked_fill(lab == ignore, 0.0)[..., None]
    return {"Softmax": [softmax], "Loss": [loss]}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    """Residual r = Y - X; Out = r²/2 where |r| <= delta (the quadratic
    branch at |r| == delta, and the gradient with it), else delta·(|r| -
    delta/2)."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": [out], "Residual": [r]}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    """-label·log(p + eps) - (1 - label)·log(1 - p + eps), elementwise,
    ``epsilon`` from the attr (the layer's default 1e-4)."""
    pred, label = promote(ins["Predicted"][0], ins["Labels"][0])
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1 - label) * torch.log(1 - pred + eps)]}
