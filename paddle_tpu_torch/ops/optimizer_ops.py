"""Optimizer update op lowering: adam (ref: paddle/fluid/operators/
optimizers/adam_op.h). Port of the paddle_tpu/ops/optimizer_ops.py
lowering: f32 math whatever the parameter's dtype, the bias correction
folded into the step size, and Beta1PowOut/Beta2PowOut advanced by one
step. The update is functional (new tensors, as in the JAX package); the
Executor writes them back to the scope. The other update ops wait for
later slices."""
import torch

from .registry import register_op


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
