"""Random op lowering: uniform_random (port of paddle_tpu/ops/
random_ops.py). Draws from the run's ``torch.Generator`` on the run's
device; the values differ from jax's for the same seed."""
import torch

from ..fluid import core
from .registry import register_op, single


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    if ins.get("ShapeTensor"):
        shape = tuple(int(v) for v in ins["ShapeTensor"])
    else:
        shape = tuple(int(s) for s in attrs["shape"])
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(shape, generator=ctx.next_rng(), device=ctx.device,
                   dtype=torch.float32)
    return single((u * (hi - lo) + lo).to(
        core.torch_dtype(attrs.get("dtype", "float32"))))
