"""Loss op lowerings: softmax_with_cross_entropy (ref: paddle/fluid/
operators/softmax_with_cross_entropy_op.cc), cross_entropy
(cross_entropy_op.cc), huber_loss (huber_loss_op.cc), log_loss
(log_loss_op.cc), and the 16 others of paddle_tpu/ops/loss_ops.py:
cross_entropy2, sigmoid_cross_entropy_with_logits, square_error_cost,
squared_l2_distance, smooth_l1_loss, hinge_loss, margin_rank_loss,
rank_loss, bpr_loss, kldiv_loss, dice_loss, center_loss, npair_loss_helper
(which raises, as the reference's does: the npair_loss layer composes
other ops), mse_loss, sampled_softmax_with_cross_entropy and
teacher_student_sigmoid_loss.
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
import numpy as np
import torch

from .detection_ops import jclip, jmax, scalar
from .math_ops import jax_abs
from .promotion import promote
from .registry import LOWERINGS, register_layout_rule, register_op, single


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


@register_layout_rule("softmax_with_cross_entropy")
def _softmax_with_ce_rule(ctx, ins, attrs, lays):
    """Hard labels over logits split on their rows only: the rank's rows
    (the labels cut to match). Over logits split on their last axis (the
    vocabulary): vocab-parallel, the logits never gathered. The max, the
    sum of the exponentials and the target's logit each come from one
    all-reduce over the axis (the max's carries no gradient, the other
    two are g); the loss is log(sum) + max - target, and the Softmax
    output stays split. Other split dims (rows) stay split on both
    outputs."""
    from ..parallel import tensor_parallel as tpl

    logits, label = ins["Logits"][0], ins["Label"][0]
    ll, lb = lays["Logits"][0], lays["Label"][0]
    last = logits.dim() - 1
    axis = attrs.get("axis", -1) % logits.dim()
    vocab = ll.axis_on(last)
    if (ll.partial or lb.partial or axis != last
            or attrs.get("soft_label", False) or vocab in lb.split):
        return None
    rows = {a: d for a, d in ll.split.items() if a != vocab}
    if set(lb.split) - set(rows):
        return None
    for a, d in sorted(rows.items()):
        if a not in lb.split:
            label = tpl.cut(label, ctx.groups[a], d)
        elif lb.split[a] != d:
            return None
    out_rows = tpl.Layout(rows)
    if vocab is None:       # split on rows only: the rank's rows
        out = LOWERINGS["softmax_with_cross_entropy"](
            ctx, {"Logits": [logits], "Label": [label]}, attrs)
        return out, {"Softmax": [ll], "Loss": [out_rows]}
    g = ctx.groups[vocab]
    x = logits.float()
    m = g.all_reduce(x.detach().amax(dim=-1, keepdim=True), op="max")
    e = torch.exp(x - m)
    total = tpl.reduce(e.sum(dim=-1, keepdim=True), g, vocab)
    per = logits.shape[-1]
    lo = g.rank * per
    lab = _squeeze_label(label).long()
    mine = (lab >= lo) & (lab < lo + per)
    picked = x.gather(-1, (lab - lo).clamp(0, per - 1)[..., None])[..., 0]
    target = tpl.reduce(torch.where(mine, picked, torch.zeros_like(picked)),
                        g, vocab)
    loss = torch.log(total[..., 0]) + m[..., 0] - target
    loss = loss.masked_fill(lab == attrs.get("ignore_index", -100), 0.0)
    softmax = (e / total).to(logits.dtype)
    return ({"Softmax": [softmax], "Loss": [loss[..., None].to(
        logits.dtype)]}, {"Softmax": [ll], "Loss": [out_rows]})


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


# ---------------------------------------------------------------------------
# jax's index rules, which the lowerings below keep: a negative index counts
# from the end once; then a gather (``w[idx]``) clamps into range, a
# take_along_axis reads NaN out of range, and a scatter-add (``.at[idx]
# .add``) drops an update out of range (torch's index_add_ raises on the CPU
# and asserts on the card, so the index is masked first)
# ---------------------------------------------------------------------------
def wrap_index(idx, n):
    """idx as int64, a negative one counted from the end once."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def gather_rows(w, idx):
    """w[idx] by jax's rule: wrapped once, then clamped to [0, n)."""
    return w[wrap_index(idx, w.shape[0]).clamp(0, w.shape[0] - 1)]


def take_along_last(x, idx):
    """jnp.take_along_axis(x, idx, axis=-1): wrapped once, NaN where the
    index stays out of range."""
    n = x.shape[-1]
    idx = wrap_index(idx, n)
    ok = (idx >= 0) & (idx < n)
    got = x.gather(-1, idx.clamp(0, n - 1))
    return torch.where(ok, got, scalar(float("nan"), x))


def scatter_add(n, idx, values, dtype=torch.float32):
    """zeros(n).at[idx].add(values) (values a tensor like idx, or a
    scalar), leading shape of `values` beyond idx kept: wrapped once, an
    update out of range dropped."""
    idx = wrap_index(idx, n)
    ok = (idx >= 0) & (idx < n)
    if not isinstance(values, torch.Tensor):
        values = torch.full(idx.shape, values, dtype=dtype, device=idx.device)
    mask = ok.reshape(ok.shape + (1,) * (values.dim() - 1)).to(values.dtype)
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, idx.clamp(0, n - 1), values * mask)


def _f32_log(v):
    """log of the f32 value v, as jnp.log of a Python float computes it
    (a weak scalar: the result rounds to x's dtype where it meets x)."""
    return float(np.log(np.float32(v)))


@register_op("cross_entropy2")
def _cross_entropy2(ctx, ins, attrs):
    """cross_entropy's Y, and MatchX the same tensor; XShape empty."""
    y = _cross_entropy(ctx, ins, attrs)["Y"][0]
    return {"Y": [y], "XShape": [y.new_zeros((0,))], "MatchX": [y]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x·label + log1p(exp(-|x|)), 0 where label ==
    ``ignore_index``; with ``normalize`` divided by the count of the other
    labels (at least 1). At x = 0 max gives half the cotangent and |x|
    jax's derivative 1."""
    x, label = promote(ins["X"][0], ins["Label"][0])
    ignore = attrs.get("ignore_index", -100)
    loss = jmax(x, 0.0) - x * label + torch.log1p(
        torch.exp(-jax_abs(x)))
    loss = torch.where(label == ignore, scalar(0.0, loss), loss)
    if attrs.get("normalize", False):
        cnt = (label != ignore).to(loss.dtype).sum()
        loss = loss / torch.clamp(cnt, min=1.0)
    return single(loss)


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    x, y = promote(ins["X"][0], ins["Y"][0])
    d = x - y
    return single(d * d)


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    """sum((x - y)²) over the last axis (kept), and sub_result x - y; Y
    may be one row, broadcast."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    d = x - y
    return {"Out": [(d * d).sum(dim=-1, keepdim=True)], "sub_result": [d]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    """d = (x - y)·InsideWeight; 0.5·d²·σ² where |d| < 1/σ², else |d| -
    0.5/σ²; times OutsideWeight, summed over every axis but the first into
    (N, 1). Diff is d."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if ins.get("InsideWeight"):
        d = d * ins["InsideWeight"][0]
    ad = torch.abs(d)
    val = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        val = val * ins["OutsideWeight"][0]
    out = val.sum(dim=tuple(range(1, x.dim())))[:, None] if x.dim() > 1 \
        else val[:, None]
    return {"Out": [out], "Diff": [d]}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    """max(0, 1 - (2·label - 1)·logits)."""
    logits, label = promote(ins["Logits"][0], ins["Labels"][0])
    z = 1.0 - (2 * label - 1) * logits
    return {"Loss": [jmax(z, 0.0)]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    """max(0, -label·(left - right) + margin), and Activated: 1 where that
    is positive."""
    label, left = promote(ins["Label"][0], ins["X1"][0])
    left, right = promote(left, ins["X2"][0])
    z = -label * (left - right) + attrs.get("margin", 0.0)
    out = jmax(z, 0.0)
    return {"Out": [out], "Activated": [(out > 0).to(out.dtype)]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    """log1p(exp(d)) - label·d, d = left - right, as the reference writes
    it (exp overflows to inf for a large d in both packages: not
    softplus)."""
    label, left = promote(ins["Label"][0], ins["Left"][0])
    left, right = promote(left, ins["Right"][0])
    d = left - right
    return single(torch.log1p(torch.exp(d)) - label * d)


@register_op("bpr_loss")
def _bpr_loss(ctx, ins, attrs):
    """mean over the last axis of log1p(exp(x - x[label])) (jax's
    take_along_axis: a label out of range reads NaN), kept."""
    x = ins["X"][0]
    lab = _squeeze_label(ins["Label"][0])
    pos = take_along_last(x, lab[:, None])
    return {"Y": [torch.log1p(torch.exp(x - pos)).mean(dim=-1,
                                                        keepdim=True)]}


@register_op("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs):
    """target·(log(max(target, 1e-12)) - x) where target > 0, else 0;
    ``reduction`` mean, sum, batchmean (sum / rows) or none."""
    x, target = promote(ins["X"][0], ins["Target"][0])
    loss = target * (torch.log(jmax(target, 1e-12)) - x)
    loss = torch.where(target > 0, loss, scalar(0.0, loss))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": [loss]}


@register_op("dice_loss")
def _dice_loss(ctx, ins, attrs):
    """mean over rows of 1 - (2·inter + eps) / (union + eps), the label one
    hot over the last axis (jax.nn.one_hot: a label out of range gives a
    zero row) and every axis but the first summed."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    lab = _squeeze_label(ins["Label"][0]).long()
    onehot = (lab[..., None] == torch.arange(
        x.shape[-1], device=x.device)).to(torch.float32)
    axes = tuple(range(1, x.dim()))
    xo, onehot = promote(x, onehot)
    inter = (xo * onehot).sum(dim=axes)
    union = x.sum(dim=axes) + onehot.sum(dim=axes)
    return single((1 - (2 * inter + eps) / (union + eps)).mean())


@register_op("center_loss")
def _center_loss(ctx, ins, attrs):
    """0.5·‖x - centers[label]‖² per row, and with ``need_update`` the
    centers moved by alpha·(sum of their rows' differences) / (count + 1).
    jax's index rules: the gather clamps a label out of range, the
    scatter-adds drop it (a negative label counts from the end first)."""
    x, centers = ins["X"][0], ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0] if ins.get("CenterUpdateRate") \
        else 0.5
    lab = _squeeze_label(ins["Label"][0])
    diff = x - gather_rows(centers, lab)
    loss = 0.5 * (diff * diff).sum(dim=-1, keepdim=True)
    if attrs.get("need_update", True):
        n = centers.shape[0]
        counts = scatter_add(n, lab, 1.0)
        upd = scatter_add(n, lab, diff)
        new_centers = centers + alpha * upd / (counts[:, None] + 1.0)
    else:
        new_centers = centers
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [new_centers]}


@register_op("npair_loss_helper")
def _npair_loss_helper(ctx, ins, attrs):
    """Registered as in the reference, where it raises too: the npair_loss
    layer composes the loss from other ops."""
    raise NotImplementedError(
        "npair_loss_helper: the npair_loss layer composes the loss from "
        "other ops (fluid/layers/nn.py npair_loss); the op has no lowering "
        "in the reference either")


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    x, y = promote(ins["X"][0], ins["Y"][0])
    d = x - y
    return single((d * d).mean())


def uniform_samples(ctx, n, high, device):
    """`n` class ids drawn uniformly from [0, high) with the run's
    generator (the reference draws with jax.random.randint)."""
    return torch.randint(0, high, (n,), generator=ctx.next_rng(),
                         device=device)


@register_op("sampled_softmax_with_cross_entropy")
def _sampled_softmax_ce(ctx, ins, attrs):
    """Sampled softmax (ref: sample_logits_op.cc), as the reference
    computes it: ``num_samples`` classes drawn uniformly from the run's
    generator; the true logits and the sampled ones, a sample that hits a
    row's label set to -1e20; all minus log(1 / classes); -log-softmax of
    the first true column, (N, 1)."""
    logits = ins["Logits"][0]
    lab = ins["Label"][0].long()
    n_classes = logits.shape[-1]
    samples = uniform_samples(ctx, attrs.get("num_samples", 64), n_classes,
                              logits.device)
    true_logits = take_along_last(logits, lab)
    sampled = logits[:, samples]
    hits = (samples[None, None, :] == lab[:, :, None]).any(dim=1)
    sampled = torch.where(hits, scalar(-1e20, logits), sampled)
    every = torch.cat([true_logits, sampled], dim=-1) - _f32_log(
        1.0 / n_classes)
    return {"Loss": [-torch.log_softmax(every, dim=-1)[:, :1]]}


@register_op("teacher_student_sigmoid_loss")
def _ts_sigmoid_loss(ctx, ins, attrs):
    """z = clip(x, -up, up); log1p(exp(-|z|)) + max(z, 0) - z·label."""
    x, label = promote(ins["X"][0], ins["Label"][0])
    up = attrs.get("soft_max_up_bound", 15.0)
    z = jclip(x, -up, up)
    return {"Y": [torch.log1p(torch.exp(-jax_abs(z)))
                  + jmax(z, 0.0) - z * label]}
