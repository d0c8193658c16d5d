"""Random op lowerings: uniform_random, gaussian_random, sampling_id
(port of paddle_tpu/ops/random_ops.py). Each draws from the run's
``torch.Generator`` on the run's device; the values differ from jax's for
the same seed."""
import torch

from ..fluid import core
from .registry import register_op, single


def _shape(ins, attrs):
    if ins.get("ShapeTensor"):
        return tuple(int(v) for v in ins["ShapeTensor"])
    return tuple(int(s) for s in attrs["shape"])


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    shape = _shape(ins, attrs)
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(shape, generator=ctx.next_rng(), device=ctx.device,
                   dtype=torch.float32)
    return single((u * (hi - lo) + lo).to(
        core.torch_dtype(attrs.get("dtype", "float32"))))


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    """mean + std * N(0, 1), drawn in f32 and cast to ``dtype`` (the conv
    weights' initializer, ``Normal(0, std)``)."""
    z = torch.randn(_shape(ins, attrs), generator=ctx.next_rng(),
                    device=ctx.device, dtype=torch.float32)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return single(out.to(core.torch_dtype(attrs.get("dtype", "float32"))))


@register_op("sampling_id")
def _sampling_id(ctx, ins, attrs):
    """One index per row of X (B, K), drawn with probability X[b, k]:
    ``jax.random.categorical`` of log(max(X, 1e-20)), the Gumbel-max
    draw. int64."""
    x = ins["X"][0]
    u = torch.rand(x.shape, generator=ctx.next_rng(), device=x.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    logits = torch.log(x.float().clamp(min=1e-20))
    return single(torch.argmax(logits + gumbel, dim=-1))
