"""Optimizer update op lowerings: sgd, momentum, adam (ref: paddle/fluid/
operators/optimizers/). Port of the paddle_tpu/ops/optimizer_ops.py
lowerings. sgd and momentum compute in the parameter's dtype, the gradient
and learning rate cast to it; adam in f32 whatever the parameter's dtype,
the bias correction folded into the step size, and Beta1PowOut/
Beta2PowOut advanced by one step. Each update is functional (new tensors,
as in the JAX package); the Executor writes them back to the scope. The
other update ops wait for later slices."""
import torch

from .registry import register_op


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
