"""Random op lowerings: uniform_random, gaussian_random (port of
paddle_tpu/ops/random_ops.py). Both draw from the run's
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
