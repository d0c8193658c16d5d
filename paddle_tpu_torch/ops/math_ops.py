"""Math op lowerings: elementwise_add/sub/mul/div/max/min/mod/floordiv,
mul, matmul, mean, scale, reduce_sum, reduce_max, abs, the comparisons
equal, not_equal, less_than, less_equal, greater_than and greater_equal,
logical_and/or/xor/not, isfinite, cumsum, clip.

Port of the paddle_tpu/ops/math_ops.py lowerings the port runs. Every
binary lowering promotes its operands by jax's rules first
(ops/promotion.py). The products go to ``torch.matmul``: they are plain
matrix products that the JAX package left to XLA, not Pallas kernels. A
bfloat16 product must sum in f32 as XLA's does; the executor sees to it on
the card (fluid/lowering.py ``f32_precision``).
"""
import torch

from .promotion import promote
from .registry import register_op, single


def _broadcast_y(x, y, axis):
    """Paddle elementwise broadcast: y aligns to x starting at `axis`
    (axis=-1 → align trailing dims)."""
    if x.shape == y.shape:
        return y
    if y.dim() == 0:
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    # trim trailing size-1 dims of y that paddle allows (e.g. shape (N,1))
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and axis + len(yshape) > x.dim():
        yshape.pop()
    new_shape = [1] * axis + yshape + [1] * (x.dim() - axis - len(yshape))
    return y.reshape(new_shape)


def _binary(fn):
    """A lowering of fn(x, y): Paddle's broadcast of Y, jax's promotion."""
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        y = _broadcast_y(x, ins["Y"][0], attrs.get("axis", -1))
        return single(fn(*promote(x, y)))

    return lower


register_op("elementwise_add")(_binary(torch.add))
register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(torch.true_divide))
register_op("elementwise_max")(_binary(torch.maximum))
register_op("elementwise_min")(_binary(torch.minimum))
# jnp.mod and jnp.floor_divide: the remainder takes the divisor's sign and
# the quotient rounds toward -inf (torch.fmod and trunc would not)
register_op("elementwise_mod")(_binary(torch.remainder))
register_op("elementwise_floordiv")(_binary(
    lambda x, y: torch.div(x, y, rounding_mode="floor")))
# comparisons give bool, after the same broadcast and promotion
register_op("equal")(_binary(torch.eq))
register_op("not_equal")(_binary(torch.ne))
register_op("less_than")(_binary(torch.lt))
register_op("less_equal")(_binary(torch.le))
register_op("greater_than")(_binary(torch.gt))
register_op("greater_equal")(_binary(torch.ge))
# logical ops read any dtype as nonzero and give bool, as jnp's do
register_op("logical_and")(_binary(torch.logical_and))
register_op("logical_or")(_binary(torch.logical_or))
register_op("logical_xor")(_binary(torch.logical_xor))


@register_op("logical_not")
def _logical_not(ctx, ins, attrs):
    return single(torch.logical_not(ins["X"][0]))


def _prod(t):
    r = 1
    for v in t:
        r *= int(v)
    return r


@register_op("mul")
def _mul(ctx, ins, attrs):
    """Flattening matmul (ref: paddle/fluid/operators/mul_op.cc): x is
    flattened to 2-D at x_num_col_dims, y at y_num_col_dims."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xnc]), _prod(xs[xnc:]))
    y2 = y.reshape(_prod(ys[:ync]), _prod(ys[ync:]))
    return single(torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = promote(ins["X"][0], ins["Y"][0])
    alpha = attrs.get("alpha", 1.0)
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = torch.mul(*promote(out, alpha))
    return single(out)


@register_op("mean")
def _mean(ctx, ins, attrs):
    return single(ins["X"][0].mean())


@register_op("scale")
def _scale(ctx, ins, attrs):
    """x·scale + bias (or (x + bias)·scale), in x's dtype: the attrs are
    weak Python scalars, and a ScaleTensor's result is cast back, as the
    JAX lowering does."""
    x = ins["X"][0]
    scale = ins["ScaleTensor"][0] if ins.get("ScaleTensor") else attrs.get(
        "scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = torch.add(*promote(torch.mul(*promote(x, scale)), bias))
    else:
        out = torch.mul(*promote(torch.add(*promote(x, bias)), scale))
    return single(out.to(x.dtype))


@register_op("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    """jnp.sum over ``dim`` (all axes with ``reduce_all`` or no dim): a
    float sums in f32 and keeps its dtype, an int keeps its own, bool sums
    to int64 (jax: int32, see ops/promotion.py)."""
    x = ins["X"][0]
    dim = attrs.get("dim", None)
    keep_dim = attrs.get("keep_dim", False)
    dtype = torch.int64 if x.dtype == torch.bool else x.dtype
    if attrs.get("reduce_all", False) or dim is None:
        out = x.sum(dtype=dtype)
        if keep_dim:
            out = out.reshape((1,) * x.dim())
    else:
        axes = tuple(d if d >= 0 else d + x.dim() for d in dim)
        # torch reads dim=() as every axis, jnp.sum as none
        out = x.sum(dim=axes, keepdim=keep_dim, dtype=dtype) if axes \
            else x.to(dtype)
    return single(out)


@register_op("reduce_max")
def _reduce_max(ctx, ins, attrs):
    """jnp.max over ``dim`` (all axes with ``reduce_all`` or no dim), in
    x's dtype. A NaN anywhere in the reduced slice gives NaN, as in jax."""
    x = ins["X"][0]
    dim = attrs.get("dim", None)
    keep_dim = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or dim is None:
        out = x.amax()
        if keep_dim:
            out = out.reshape((1,) * x.dim())
    else:
        axes = tuple(d if d >= 0 else d + x.dim() for d in dim)
        # torch reads dim=() as every axis, jnp.max as none
        out = x.amax(dim=axes, keepdim=keep_dim) if axes else x
    return single(out)


@register_op("abs")
def _abs(ctx, ins, attrs):
    return single(torch.abs(ins["X"][0]))


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    """One 0-dim bool: every element finite (jnp.all(jnp.isfinite(x)))."""
    return single(torch.isfinite(ins["X"][0]).all())


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """Running sum along ``axis`` (every element with ``flatten``), from
    the end with ``reverse``; ``exclusive`` shifts it one place, so the
    first element is 0 and the last one's own value is left out. An int
    keeps its dtype, bool sums to int64 (jax: int32, see
    ops/promotion.py)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    axis %= x.dim()
    rev = attrs.get("reverse", False)
    if rev:
        x = x.flip(axis)
    out = torch.cumsum(x, dim=axis,
                       dtype=torch.int64 if x.dtype == torch.bool
                       else x.dtype)
    if attrs.get("exclusive", False) and out.shape[axis]:
        zero = torch.zeros_like(out.narrow(axis, 0, 1))
        out = torch.cat([zero, out.narrow(axis, 0, out.shape[axis] - 1)],
                        dim=axis)
    if rev:
        out = out.flip(axis)
    return single(out)


@register_op("clip")
def _clip(ctx, ins, attrs):
    """jnp.clip(x, Min, Max): minimum(maximum(x, lo), hi), the bounds from
    the Min/Max inputs or the min/max attrs (weak scalars, rounded to x's
    dtype as jax rounds them). Not ``torch.clamp``: its gradient is 1 at a
    bound, where jax's maximum and minimum give each side of a tie half,
    so x's gradient is 0.5 at lo and at hi (torch.maximum and
    torch.minimum split ties the same way); a saturated sigmoid clipped
    to [1e-7, 1 - 1e-7] lands on the bound."""
    x = ins["X"][0]
    lo = ins["Min"][0] if ins.get("Min") else attrs["min"]
    hi = ins["Max"][0] if ins.get("Max") else attrs["max"]
    out = torch.maximum(*_as_tensors(x, lo))
    return single(torch.minimum(*_as_tensors(out, hi)))


def _as_tensors(x, v):
    """(x, v) promoted by jax's rules, a Python scalar `v` made a 0-dim
    tensor of the result dtype on x's device."""
    x, v = promote(x, v)
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, dtype=x.dtype, device=x.device)
    return x, v
