"""NN op lowerings: gelu, lookup_table_v2, layer_norm, dropout.

Port of the paddle_tpu/ops/nn_ops.py lowerings this slice runs.
``layer_norm`` always goes through ``LayerNorm`` (ops/cuda_layernorm.py),
whose forward and backward are the LayerNorm kernels on the card, for
every ``begin_norm_axis``: x is flattened to (prod(x.shape[:begin]),
prod(x.shape[begin:])). With autograd off (serving) the Function records
no graph and launches the same forward kernel. The JAX package reaches its Pallas kernel only behind
PADDLE_TPU_PALLAS_LN, because XLA fused the plain graph; the port has no
such compiler.
"""
import torch
import torch.nn.functional as F

from .cuda_layernorm import LayerNorm
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
    args = (x.reshape(n, h).contiguous(),
            scale.contiguous() if scale is not None else None,
            bias.contiguous() if bias is not None else None, eps)
    y, mean, rstd = LayerNorm.apply(*args)
    # the kernel's rstd turned back into the op's Variance output, squeezed
    # as the JAX lowering squeezes its keepdims statistics
    var = 1.0 / (rstd * rstd) - eps
    return {
        "Y": [y.reshape(x.shape)],
        "Mean": [mean.reshape(lead).squeeze()],
        "Variance": [var.reshape(lead).squeeze()],
    }


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    """Elementwise dropout. The keep mask is drawn from the run's
    generator at exactly 1-p (the JAX package's 8-bit quantised mask is
    not ported); its bits differ from the JAX package's, which draws from
    jax.random."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep_prob = 1.0 - p
    keep = torch.rand(x.shape, generator=ctx.next_rng(),
                      device=x.device) < keep_prob
    if impl == "upscale_in_train":
        x = x / max(keep_prob, 1e-8)
    out = x.masked_fill(~keep, 0.0)
    return {"Out": [out], "Mask": [keep.to(out.dtype)]}
