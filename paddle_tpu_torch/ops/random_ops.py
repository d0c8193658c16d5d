"""Random op lowerings, port of paddle_tpu/ops/random_ops.py:
uniform_random, gaussian_random, sampling_id, their batch-size-like forms,
truncated_gaussian_random, randint, randperm, multinomial, random_crop,
and shuffle_channel (no draw). Each draw comes from the run's
``torch.Generator`` on the run's device; the values differ from jax's for
the same seed, their distributions do not. In a data-parallel run the ops
of a static shape draw alike on every rank (``next_rng(replicated=True)``:
the JAX package draws them once, replicated), and those over a rank's
slice of the batch draw its own (ROADMAP.md Queue 3)."""
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
    u = torch.rand(shape, generator=ctx.next_rng(replicated=True), device=ctx.device,
                   dtype=torch.float32)
    return single((u * (hi - lo) + lo).to(
        core.torch_dtype(attrs.get("dtype", "float32"))))


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    """mean + std * N(0, 1), drawn in f32 and cast to ``dtype`` (the conv
    weights' initializer, ``Normal(0, std)``)."""
    z = torch.randn(_shape(ins, attrs), generator=ctx.next_rng(replicated=True),
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


def _dtype(attrs, default="float32"):
    return core.torch_dtype(attrs.get("dtype", default))


def _batch_like(ins, attrs):
    """``shape`` with its ``output_dim_idx`` entry taken from Input's
    ``input_dim_idx`` dim."""
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)])
    return tuple(shape)


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_batch_like(ins, attrs), generator=ctx.next_rng(),
                   device=ctx.device, dtype=torch.float32)
    return single((u * (hi - lo) + lo).to(_dtype(attrs)))


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_bsl(ctx, ins, attrs):
    z = torch.randn(_batch_like(ins, attrs), generator=ctx.next_rng(),
                    device=ctx.device, dtype=torch.float32)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return single(out.to(_dtype(attrs)))


# erf(∓2 / √2): the standard normal truncated to [-2, 2], in erf's terms
_ERF_HI = 0.9544997361036416


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """mean + std·z, z standard normal truncated to [-2, 2] as
    ``jax.random.truncated_normal`` draws it: √2·erfinv(u), u uniform
    between erf(-√2) and erf(√2), clipped to the bounds."""
    u = torch.rand(_shape(ins, attrs), generator=ctx.next_rng(replicated=True),
                   device=ctx.device, dtype=torch.float32)
    u = (2.0 * u - 1.0) * _ERF_HI
    z = (torch.special.erfinv(u) * (2.0 ** 0.5)).clamp(-2.0, 2.0)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return single(out.to(_dtype(attrs)))


@register_op("randint")
def _randint(ctx, ins, attrs):
    """Integers uniform in [low, high), ``dtype`` (int64 by default; the
    reference: int32, jax without x64)."""
    return single(torch.randint(
        attrs.get("low", 0), attrs.get("high", 100), _shape(ins, attrs),
        generator=ctx.next_rng(replicated=True), device=ctx.device,
        dtype=_dtype(attrs, "int64")))


@register_op("randperm")
def _randperm(ctx, ins, attrs):
    return single(torch.randperm(attrs["n"], generator=ctx.next_rng(replicated=True),
                                 device=ctx.device,
                                 dtype=_dtype(attrs, "int64")))


@register_op("multinomial")
def _multinomial(ctx, ins, attrs):
    """``num_samples`` draws with replacement per row of X (..., K), each
    with probability X[..., k]: the Gumbel-max draw of
    ``jax.random.categorical`` over log(max(X, 1e-20)). int64, shape
    (..., num_samples)."""
    x = ins["X"][0]
    num = attrs.get("num_samples", 1)
    u = torch.rand((num,) + tuple(x.shape), generator=ctx.next_rng(),
                   device=x.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(
        torch.float32).tiny)))
    draws = torch.argmax(torch.log(x.float().clamp(min=1e-20)) + gumbel,
                         dim=-1)
    return single(torch.movedim(draws, 0, -1))


@register_op("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    """The C channels as (group, C/group), transposed: no draw."""
    x = ins["X"][0]
    g = attrs.get("group", 1)
    n, c, h, w = x.shape
    return single(x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
        n, c, h, w))


@register_op("random_crop")
def _random_crop(ctx, ins, attrs):
    """X's trailing len(shape) dims cut to ``shape`` at one offset per dim,
    uniform in [0, dim - size], the same for the whole batch. The offsets
    stay on the device: the crop gathers rows at offset + arange(size)."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    lead = x.dim() - len(shape)
    gen = ctx.next_rng()
    out = x
    for i, s in enumerate(shape):
        dim = x.shape[lead + i]
        start = torch.randint(0, dim - s + 1, (1,), generator=gen,
                              device=x.device)
        rows = start + torch.arange(s, device=x.device)
        out = out.index_select(lead + i, rows)
    return single(out)
