"""NN op lowerings: gelu, lookup_table_v2, layer_norm.

Port of the paddle_tpu/ops/nn_ops.py lowerings this slice runs.
``layer_norm`` always goes through the LayerNorm kernel
(ops/cuda_layernorm.py) on the card, for every ``begin_norm_axis``: x is
flattened to (prod(x.shape[:begin]), prod(x.shape[begin:])). The JAX
package reaches its Pallas kernel only behind PADDLE_TPU_PALLAS_LN,
because XLA fused the plain graph; the port has no such compiler.
"""
import torch
import torch.nn.functional as F

from .cuda_layernorm import layer_norm_fwd
from .registry import register_op, single


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return single(F.gelu(ins["X"][0], approximate=approximate))


@register_op("lookup_table_v2")
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    padding_idx = attrs.get("padding_idx", -1)
    if ids.dim() >= 2 and ids.shape[-1] == 1 and attrs.get("_squeeze", True):
        ids = ids[..., 0]
    # jnp.take's semantics: a negative id counts from the end, and an id
    # outside [-vocab, vocab) reads NaN instead of faulting the device
    # (ids arrive from outside the program)
    vocab = w.shape[0]
    idx = torch.where(ids < 0, ids + vocab, ids)
    valid = (idx >= 0) & (idx < vocab)
    out = w[idx.clamp(0, vocab - 1)]
    out = torch.where(valid[..., None], out,
                      torch.full((), float("nan"), dtype=w.dtype,
                                 device=w.device))
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return single(out)


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    n = 1
    for s in lead:
        n *= int(s)
    h = x.numel() // max(n, 1)
    scale = ins["Scale"][0].reshape(h) if ins.get("Scale") else None
    bias = ins["Bias"][0].reshape(h) if ins.get("Bias") else None
    y, mean, rstd = layer_norm_fwd(
        x.reshape(n, h).contiguous(),
        scale.contiguous() if scale is not None else None,
        bias.contiguous() if bias is not None else None, eps)
    # the kernel's rstd turned back into the op's Variance output, squeezed
    # as the JAX lowering squeezes its keepdims statistics
    var = 1.0 / (rstd * rstd) - eps
    return {
        "Y": [y.reshape(x.shape)],
        "Mean": [mean.reshape(lead).squeeze()],
        "Variance": [var.reshape(lead).squeeze()],
    }
