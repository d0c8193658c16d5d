"""Optimizer update op lowerings (ref: paddle/fluid/operators/optimizers/):
sgd, momentum, dgc_momentum, lars_momentum, adagrad, decayed_adagrad,
adadelta, adam, adamax, rmsprop, ftrl, lamb, dpsgd. Port of the
paddle_tpu/ops/optimizer_ops.py lowerings, each in the dtype the JAX
lowering computes in: sgd, momentum and dgc_momentum in the parameter's,
the gradient and learning rate cast to it; adam in f32 whatever the
parameter's dtype, the bias correction folded into the step size; the
others as their operands promote by jax's rules (the learning rate is an
f32 [1] tensor, the attrs weak Python scalars). Each update is functional
(new tensors, as in the JAX package); the Executor writes them back to the
scope.

The norms of lars_momentum, lamb, dpsgd and dgc's local clip reduce over
the whole parameter on the device. dgc_momentum's threshold is
``jnp.quantile``'s linear interpolation, read with two ``kthvalue``
selections (``torch.quantile`` refuses more than 2^24 elements, and a
BERT word embedding has 23.4 M). dpsgd's noise comes from the run's
generator, so it cannot match the JAX package's draws bit for bit."""
import torch

from .registry import LOWERINGS, register_layout_rule, register_op


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    return {"ParamOut": [p - lr.to(p.dtype) * g.to(p.dtype)]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    """v' = mu·v + g; p' = p - lr·v', or with Nesterov p - (g + mu·v')·lr."""
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = ins["Grad"][0].to(p.dtype)
    lr = ins["LearningRate"][0].to(p.dtype)
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


def _adam_core(p, g, m, v, beta1_pow, beta2_pow, lr, beta1, beta2, eps):
    m_new = beta1 * m + (1 - beta1) * g
    v_new = beta2 * v + (1 - beta2) * g * g
    lr_t = lr * torch.sqrt(1 - beta2_pow) / (1 - beta1_pow)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return p_new, m_new, v_new


@register_op("adam")
def _adam(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    p_new, m_new, v_new = _adam_core(
        p.float(), g.float(), m, v, b1p, b2p, lr, beta1, beta2, eps)
    return {
        "ParamOut": [p_new.to(p.dtype)],
        "Moment1Out": [m_new],
        "Moment2Out": [v_new],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }


def _sq_norm(x):
    return torch.sqrt((x * x).sum())


@register_op("dgc_momentum")
def _dgc_momentum(ctx, ins, attrs):
    """Deep Gradient Compression momentum: plain momentum before
    ``rampup_begin_step``; from it on, the momentum-corrected gradient
    accumulates in V and only the elements of |V| at or above the
    sparsity quantile update the parameter (the rest stay banked in U and
    V). The sparsity steps through ``sparsity`` over ``rampup_step``
    steps. Reading the quantile's rank waits for the device once."""
    p = ins["Param"][0]
    g = ins["Grad"][0].to(p.dtype)
    u, v = ins["U"][0], ins["V"][0]
    step = ins["CurrentStep"][0].reshape(())
    lr = ins["LearningRate"][0].to(p.dtype)
    mu = attrs.get("mu", 0.9)
    begin = attrs.get("rampup_begin_step", 0)
    rampup = max(attrs.get("rampup_step", 1), 1)
    levels = attrs.get("sparsity", [0.999])
    clip_norm = attrs.get("local_grad_clip_norm", -1.0)
    if clip_norm and clip_norm > 0:
        g = g * torch.clamp(clip_norm / torch.clamp(_sq_norm(g), min=1e-12),
                            max=1.0)
    vel = mu * u + g
    p_plain = p - lr * vel
    v_new = v + vel
    seg = torch.div((step - begin) * len(levels), rampup,
                    rounding_mode="floor").to(torch.int32).clamp(
                        0, len(levels) - 1)
    s = torch.tensor(levels, dtype=torch.float32, device=p.device)[seg]
    absv = v_new.abs()
    thr = _quantile(absv.reshape(-1).to(torch.float32), s)
    mask = (absv >= thr.to(p.dtype)).to(p.dtype)
    p_dgc = p - lr * (v_new * mask)
    use_dgc = step >= begin
    return {
        "ParamOut": [torch.where(use_dgc, p_dgc, p_plain)],
        "UOut": [torch.where(use_dgc, vel * (1.0 - mask), vel)],
        "VOut": [torch.where(use_dgc, v_new * (1.0 - mask), v)],
        "StepOut": [(step + 1).reshape(1)],
    }


def _quantile(a, q):
    """jnp.quantile(a, q) of a flat f32 `a` at a 0-dim f32 `q`, its linear
    rule step for step: pos = q·(n - 1) in f32, the order statistics at
    floor(pos) and ceil(pos) weighted by 1 - (pos - floor) and
    pos - floor."""
    n = a.numel()
    pos = q * torch.tensor(float(n), dtype=torch.float32,
                           device=a.device).sub(1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lo_i, hi_i = (int(min(max(t.item(), 0), n - 1)) for t in (low, high))
    lo_v = torch.kthvalue(a, lo_i + 1).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(a, hi_i + 1).values
    return lo_v * (1 - hw) + hi_v * hw


@register_op("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    """v' = mu·v + local_lr·(g + decay·p), p' = p - v'; the local rate
    lr·coeff·|p| / (|g| + decay·|p| + 1e-12) where both norms are
    positive, else lr."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    pn, gn = _sq_norm(p), _sq_norm(g)
    local_lr = torch.where((pn > 0) & (gn > 0),
                           lr * coeff * pn / (gn + decay * pn + 1e-12), lr)
    v_new = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_grad = ins["AvgSquaredGrad"][0]
    avg_sq_upd = ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_grad + (1 - rho) * g * g
    upd = -torch.sqrt((avg_sq_upd + eps) / (g2 + eps)) * g
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [g2],
            "AvgSquaredUpdateOut": [rho * avg_sq_upd + (1 - rho) * upd * upd]}


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    """Adam with the infinity norm; Beta1Pow advances in a separate
    ``scale`` op (AdamaxOptimizer._finish_update)."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m, inf_norm = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = beta1 * m + (1 - beta1) * g
    inf_new = torch.maximum(beta2 * inf_norm, torch.abs(g))
    p_new = p - (lr / (1 - b1p)) * m_new / (inf_new + eps)
    return {"ParamOut": [p_new], "MomentOut": [m_new],
            "InfNormOut": [inf_new]}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    """RMSProp with momentum; ``centered`` subtracts the mean gradient's
    square (MeanGradOut only then)."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    out = {}
    if attrs.get("centered", False):
        mg_new = rho * ins["MeanGrad"][0] + (1 - rho) * g
        denom = ms_new - mg_new * mg_new + eps
        out["MeanGradOut"] = [mg_new]
    else:
        denom = ms_new + eps
    mom_new = momentum * mom + lr * g / torch.sqrt(denom)
    out.update(ParamOut=[p - mom_new], MeanSquareOut=[ms_new],
               MomentOut=[mom_new])
    return out


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    quad = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    pre_shrink = (l1 * torch.sign(new_lin) - new_lin) / quad
    p_new = torch.where(torch.abs(new_lin) > l1, pre_shrink,
                        torch.zeros_like(pre_shrink))
    return {"ParamOut": [p_new], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


@register_op("lamb")
def _lamb(ctx, ins, attrs):
    """Adam's direction plus weight decay, scaled by the layer's trust
    ratio |p| / |r| (1 where either norm is 0)."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new = beta1 * m + (1 - beta1) * g
    v_new = beta2 * v + (1 - beta2) * g * g
    r = (m_new / (1 - b1p)) / (torch.sqrt(v_new / (1 - b2p)) + eps) + wd * p
    p_norm, r_norm = _sq_norm(p), _sq_norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return {
        "ParamOut": [p - lr * trust * r],
        "Moment1Out": [m_new],
        "Moment2Out": [v_new],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }


@register_op("dpsgd")
def _dpsgd(ctx, ins, attrs):
    """Differentially private SGD: g clipped to L2 norm ``clip``, plus
    N(0, 1)·sigma·clip / batch_size noise from the run's generator."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g = g * torch.clamp(clip / torch.clamp(_sq_norm(g), min=1e-12), max=1.0)
    # the update of a replicated parameter: alike on every rank
    noise = sigma * clip * torch.randn(
        g.shape, generator=ctx.next_rng(replicated=True), device=g.device)
    return {"ParamOut": [p - lr * (g + noise / batch_size)]}


# ---------------------------------------------------------------------------
# layout rule under tensor parallelism and ZeRO-1 (parallel/tensor_parallel.py)
# ---------------------------------------------------------------------------
# the per-element slots of the update ops that run on a block as they run
# on the whole value (the norms of lars, lamb and dpsgd read all of it)
_ELEMENTWISE_SLOTS = {
    "sgd": ("Param", "Grad"),
    "momentum": ("Param", "Grad", "Velocity"),
    "adam": ("Param", "Grad", "Moment1", "Moment2"),
    "adagrad": ("Param", "Grad", "Moment"),
    "decayed_adagrad": ("Param", "Grad", "Moment"),
    "adamax": ("Param", "Grad", "Moment", "InfNorm"),
    "rmsprop": ("Param", "Grad", "MeanSquare", "Moment", "MeanGrad"),
}


@register_layout_rule(*_ELEMENTWISE_SLOTS)
def _update_rule(ctx, ins, attrs, lays):
    """The update on blocks. A tp-split parameter, its gradient and its
    moments share a layout, and the op runs on the rank's blocks. Under
    ZeRO-1 the moments (and the gradient, reduce-scattered by the dp
    hook) are split over dp as well: the parameter is cut to the same
    block, the op runs there, and an all-gather over dp makes the
    parameter whole again. Other inputs (the learning rate, the beta
    powers) must be whole."""
    from ..parallel import tensor_parallel as tpl

    op = ctx.current_op.type
    slots = [s for s in _ELEMENTWISE_SLOTS[op] if ins.get(s)]
    if any(not lay.whole for slot, ls in lays.items() if slot not in slots
           for lay in ls):
        return None
    ref = max((lays[s][0] for s in slots), key=lambda lay: len(lay.split))
    ins = dict(ins)
    for s in slots:
        x, lay = tpl.resolve_partial(ctx, ins[s][0], lays[s][0])
        if any(ref.split.get(a) != d for a, d in lay.split.items()):
            return None
        for a, d in sorted(ref.split.items()):
            if a not in lay.split:
                x = tpl.cut(x, ctx.groups[a], d)
        ins[s] = [x]
    out = LOWERINGS[op](ctx, ins, attrs)
    param = tpl.Layout(lays["Param"][0].split)
    out["ParamOut"] = [tpl.conform(ctx, out["ParamOut"][0], ref, param)]
    out_lays = {"ParamOut": [param]}
    for slot in out:
        if slot != "ParamOut" and slot[:-3] in slots:
            out_lays[slot] = [ref]
    return out, out_lays
