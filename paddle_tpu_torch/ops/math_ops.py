"""Math op lowerings: elementwise_add/sub/mul/div/max/min/mod/floordiv/pow,
mul, matmul, mean, scale, reduce_sum, reduce_mean, reduce_max, reduce_min,
reduce_prod, reduce_all, reduce_any, sum, abs, sign, pow, squared_l2_norm,
clip_by_norm, the comparisons equal, not_equal, less_than, less_equal,
greater_than and greater_equal, logical_and/or/xor/not, isfinite, cumsum,
clip, l2_normalize, cos_sim, bilinear_tensor_product, frobenius_norm, kron,
dot.

Port of the paddle_tpu/ops/math_ops.py lowerings the port runs. Every
binary lowering promotes its operands by jax's rules first
(ops/promotion.py). The products go to ``torch.matmul``: they are plain
matrix products that the JAX package left to XLA, not Pallas kernels. A
bfloat16 product must sum in f32 as XLA's does; the executor sees to it on
the card (fluid/lowering.py ``f32_precision``).
"""
import torch

from .detection_ops import jmax
from .promotion import promote
from .registry import LOWERINGS, register_layout_rule, register_op, single


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
register_op("elementwise_pow")(_binary(torch.pow))
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


@register_op("reduce_mean")
def _reduce_mean(ctx, ins, attrs):
    """jnp.mean over ``dim`` (all axes with ``reduce_all`` or no dim): a
    float keeps its dtype, an int or bool averages in float32."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    dim = attrs.get("dim", None)
    keep_dim = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or dim is None:
        out = x.mean()
        if keep_dim:
            out = out.reshape((1,) * x.dim())
    else:
        axes = tuple(d if d >= 0 else d + x.dim() for d in dim)
        # torch reads dim=() as every axis, jnp.mean as none
        out = x.mean(dim=axes, keepdim=keep_dim) if axes else x
    return single(out)


def _reduce(fn):
    """A reduction lowering over ``dim`` (all axes with ``reduce_all`` or
    no dim; none with an empty dim, as jnp reads axis=()), `fn(x, axes,
    keep_dim)` given the sorted non-negative axes."""
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        dim = attrs.get("dim", None)
        keep_dim = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False) or dim is None:
            axes = tuple(range(x.dim()))
        else:
            axes = tuple(sorted(d if d >= 0 else d + x.dim() for d in dim))
        return single(fn(x, axes, keep_dim) if axes else fn(x, (), False))

    return lower


def _prod_over(x, axes, keep_dim):
    """jnp.prod over `axes`: the reduced axes moved last and flattened, one
    ``prod`` over them (its gradient right with zeros in the row, as
    jax's). An int keeps its dtype, bool multiplies to int64 (jax:
    int32)."""
    if not axes:
        return x.to(torch.int64) if x.dtype == torch.bool else x
    kept = [d for d in range(x.dim()) if d not in axes]
    y = x.permute(kept + list(axes)).reshape(
        [x.shape[d] for d in kept] + [-1])
    out = y.prod(dim=-1, dtype=torch.int64 if x.dtype == torch.bool
                 else None)
    if keep_dim:
        out = out.reshape([1 if d in axes else x.shape[d]
                           for d in range(x.dim())])
    return out


# amax and amin, in x's dtype: a NaN in the reduced slice gives NaN, and a
# tied extremum's gradient splits among the ties, as jnp.max's and jnp.min's
register_op("reduce_max")(_reduce(
    lambda x, axes, keep: x.amax(dim=axes, keepdim=keep) if axes else x))
register_op("reduce_min")(_reduce(
    lambda x, axes, keep: x.amin(dim=axes, keepdim=keep) if axes else x))
register_op("reduce_prod")(_reduce(_prod_over))
# any dtype read as nonzero; the result bool
register_op("reduce_all")(_reduce(
    lambda x, axes, keep: torch.all(x.bool(), dim=axes, keepdim=keep)
    if axes else x.bool()))
register_op("reduce_any")(_reduce(
    lambda x, axes, keep: torch.any(x.bool(), dim=axes, keepdim=keep)
    if axes else x.bool()))


def _norm(x, axis):
    """sqrt(sum(x·x)) over `axis`, kept: its gradient at a zero row is
    sqrt's at 0, NaN after a zero cotangent in both packages."""
    return torch.sqrt((x * x).sum(dim=axis, keepdim=True))


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    """x / max(‖x‖, epsilon) over ``axis``; Norm is ‖x‖ (kept dims)."""
    x = ins["X"][0]
    norm = _norm(x, attrs.get("axis", -1))
    return {"Out": [x / jmax(norm, attrs.get("epsilon", 1e-12))],
            "Norm": [norm]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """sum(x·y) / max(‖x‖·‖y‖, 1e-12) over the last axis (Y may be one
    row, broadcast), with XNorm and YNorm; a zero row gives 0 and, through
    sqrt(0), a NaN gradient, as jax.vjp gives."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    xn, yn = _norm(x, -1), _norm(y, -1)
    return {"Out": [(x * y).sum(dim=-1, keepdim=True) / jmax(xn * yn,
                                                               1e-12)],
            "XNorm": [xn], "YNorm": [yn]}


@register_op("bilinear_tensor_product")
def _bilinear(ctx, ins, attrs):
    """out[b, o] = x[b]ᵀ·W[o]·y[b] (+ Bias), W of shape (size, dx, dy)."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if ins.get("Bias"):
        out = torch.add(*promote(out, ins["Bias"][0]))
    return single(out)


@register_op("frobenius_norm")
def _frobenius_norm(ctx, ins, attrs):
    """sqrt(sum(x·x)) over every element, 0-dim (the reference's lowering
    reads no ``dim``)."""
    x = ins["X"][0]
    return single(torch.sqrt((x * x).sum()))


@register_op("kron")
def _kron(ctx, ins, attrs):
    return single(torch.kron(*promote(ins["X"][0], ins["Y"][0])))


@register_op("dot")
def _dot(ctx, ins, attrs):
    """sum(x·y) over the last axis, kept for a batch of rows."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    return single((x * y).sum(dim=-1, keepdim=x.dim() > 1))


def jax_abs(x):
    """|x| with jax's derivative: 1 at x = ±0 (select(x >= 0, g, -g)),
    where ``torch.abs``'s is 0; an int or bool x goes to torch.abs."""
    if not x.is_floating_point():
        return torch.abs(x)
    return torch.where(x >= 0, x, -x)


@register_op("abs")
def _abs(ctx, ins, attrs):
    return single(jax_abs(ins["X"][0]))


@register_op("sign")
def _sign(ctx, ins, attrs):
    return single(torch.sign(ins["X"][0]))


@register_op("pow")
def _pow(ctx, ins, attrs):
    """x ** factor: the FactorTensor input, else the ``factor`` attr (a
    weak Python scalar)."""
    x = ins["X"][0]
    factor = ins["FactorTensor"][0] if ins.get("FactorTensor") else \
        attrs.get("factor", 1.0)
    return single(torch.pow(*promote(x, factor)))


@register_op("sum")
def _sum(ctx, ins, attrs):
    """X[0] + X[1] + ..., left to right, each add promoted by jax's
    rules."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*promote(out, x))
    return single(out)


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    """sum(x·x) as a 0-dim tensor of x's dtype."""
    x = ins["X"][0]
    return single((x * x).sum().reshape(()))


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """x · max_norm / ||x|| where the L2 norm ||x|| exceeds ``max_norm``,
    else x, in x's dtype (the JAX lowering's weak scalars)."""
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt((x * x).sum())
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return single(x * scale.to(x.dtype))


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


# ---------------------------------------------------------------------------
# layout rules under tensor and sequence parallelism
# (parallel/tensor_parallel.py): where each op's output lies when an input is
# split or partial over a mesh axis; None sends the op to the fallback
# ---------------------------------------------------------------------------
def _tpl():
    from ..parallel import tensor_parallel

    return tensor_parallel


def _y_dims(gx, gy, axis):
    """{dim of Y: dim of X} of Paddle's broadcast of Y into X, read from
    the whole values' shapes; None when Y does not align into X."""
    if gx == gy:
        return {d: d for d in range(len(gy))}
    if len(gy) > len(gx):
        return None
    if axis == -1 or axis is None:
        axis = len(gx) - len(gy)
    n = len(gy)
    while n and gy[n - 1] == 1 and axis + n > len(gx):
        n -= 1
    if axis < 0 or axis + n > len(gx):
        return None
    return {d: axis + d for d in range(n)}


def _binary_rule(fn, linear):
    """X and Y split alike on the dims they share; a whole operand is cut
    to the other's block (after f), or entered whole where it broadcasts;
    partial operands are reduced first, except a sum or difference of two
    values partial over the same axis, which stays partial."""
    def rule(ctx, ins, attrs, lays):
        tpl = _tpl()
        x, y = ins["X"][0], ins["Y"][0]
        lx, ly = lays["X"][0], lays["Y"][0]
        both = lx.partial & ly.partial if linear else frozenset()
        x, lx = tpl.resolve_partial(ctx, x, lx, both)
        y, ly = tpl.resolve_partial(ctx, y, ly, both)
        gx = tpl.global_shape(x.shape, lx, ctx.groups)
        gy = tpl.global_shape(y.shape, ly, ctx.groups)
        ymap = _y_dims(gx, gy, attrs.get("axis", -1))
        if ymap is None:
            return None
        back = {xd: yd for yd, xd in ymap.items()}
        for a in sorted(set(lx.split) | set(ly.split)):
            g = ctx.groups[a]
            dx, dy = lx.split.get(a), ly.split.get(a)
            if dx is not None and dy is not None:
                if ymap.get(dy) != dx:
                    return None
            elif dx is not None:
                yd = back.get(dx)
                if yd is not None and gy[yd] == gx[dx]:
                    y = tpl.scatter(y, g, a, yd)
                    ly = ly.with_split(a, yd)
                elif yd is None or gy[yd] == 1:
                    y = tpl.enter(y, g, a)
                else:
                    return None
            else:
                xd = ymap.get(dy)
                if xd is None or gx[xd] != gy[dy]:
                    return None
                x = tpl.scatter(x, g, a, xd)
                lx = lx.with_split(a, xd)
        out = fn(ctx, {"X": [x], "Y": [y]}, attrs)
        return out, {"Out": [tpl.Layout(lx.split, both)]}

    return rule


for _name in ("elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_div", "elementwise_max", "elementwise_min",
              "elementwise_pow", "equal", "not_equal", "less_than",
              "less_equal", "greater_than", "greater_equal"):
    register_layout_rule(_name)(_binary_rule(
        LOWERINGS[_name], _name in ("elementwise_add", "elementwise_sub")))


def _fits(x, dim, group):
    return x.shape[dim] % group.size == 0


@register_layout_rule("mul")
def _mul_rule(ctx, ins, attrs, lays):
    """X split on a row dim, or Y on a column dim: the output is split
    there (the other operand entered whole). X split on its first
    contraction dim, or Y on its first (dim 0): the other operand is cut
    to match and the output is partial."""
    tpl = _tpl()
    x, y = ins["X"][0], ins["Y"][0]
    x, lx = tpl.resolve_partial(ctx, x, lays["X"][0])
    y, ly = tpl.resolve_partial(ctx, y, lays["Y"][0])
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    split, partial = {}, set()
    for a in sorted(set(lx.split) | set(ly.split)):
        g = ctx.groups[a]
        dx, dy = lx.split.get(a), ly.split.get(a)
        if dx is not None and dx < xnc:
            if dy is not None:
                return None
            y = tpl.enter(y, g, a)
            split[a] = dx
        elif dx is not None:
            if dx != xnc or (dy is not None and dy != 0):
                return None
            if dy is None:
                if not _fits(y, 0, g):
                    return None
                y = tpl.scatter(y, g, a, 0)
            partial.add(a)
        elif dy >= ync:
            x = tpl.enter(x, g, a)
            split[a] = xnc + dy - ync
        else:
            if dy != 0 or not _fits(x, xnc, g):
                return None
            x = tpl.scatter(x, g, a, xnc)
            partial.add(a)
    out = LOWERINGS["mul"](ctx, {"X": [x], "Y": [y]}, attrs)
    return out, {"Out": [tpl.Layout(split, partial)]}


@register_layout_rule("matmul")
def _matmul_rule(ctx, ins, attrs, lays):
    """Batched products of operands of two or more dims: a batch dim split
    alike on both (or cut on the whole one, or entered where it
    broadcasts) stays split; X's row dim or Y's column dim split gives an
    output split there; the contraction dim split on both (the whole one
    cut to match) gives a partial output."""
    tpl = _tpl()
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() < 2 or y.dim() < 2:
        return None
    x, lx = tpl.resolve_partial(ctx, x, lays["X"][0])
    y, ly = tpl.resolve_partial(ctx, y, lays["Y"][0])
    nx, ny = x.dim(), y.dim()
    no = max(nx, ny)
    xm, xk = (nx - 1, nx - 2) if attrs.get("transpose_X") else (nx - 2,
                                                               nx - 1)
    yk, yn = (ny - 1, ny - 2) if attrs.get("transpose_Y") else (ny - 2,
                                                               ny - 1)
    gx = tpl.global_shape(x.shape, lx, ctx.groups)
    gy = tpl.global_shape(y.shape, ly, ctx.groups)
    split, partial = {}, set()
    for a in sorted(set(lx.split) | set(ly.split)):
        g = ctx.groups[a]
        dx, dy = lx.split.get(a), ly.split.get(a)
        if dx == xk or dy == yk:
            if dx is None:
                if not _fits(x, xk, g):
                    return None
                x = tpl.scatter(x, g, a, xk)
            elif dx != xk:
                return None
            if dy is None:
                if not _fits(y, yk, g):
                    return None
                y = tpl.scatter(y, g, a, yk)
            elif dy != yk:
                return None
            partial.add(a)
        elif dx == xm:
            if dy is not None:
                return None
            y = tpl.enter(y, g, a)
            split[a] = no - 2
        elif dy == yn:
            if dx is not None:
                return None
            x = tpl.enter(x, g, a)
            split[a] = no - 1
        else:
            # a batch dim of one operand, matched on the other
            od = dx + no - nx if dx is not None else dy + no - ny
            i, j = od - (no - nx), od - (no - ny)
            if dx is not None and dy is not None:
                if dy != j:
                    return None
            elif dx is not None:
                if j < 0 or gy[j] == 1:
                    y = tpl.enter(y, g, a)
                elif gy[j] == gx[dx]:
                    y = tpl.scatter(y, g, a, j)
                else:
                    return None
            else:
                if i < 0 or gx[i] == 1:
                    x = tpl.enter(x, g, a)
                elif gx[i] == gy[dy]:
                    x = tpl.scatter(x, g, a, i)
                else:
                    return None
            split[a] = od
    out = LOWERINGS["matmul"](ctx, {"X": [x], "Y": [y]}, attrs)
    return out, {"Out": [tpl.Layout(split, partial)]}


@register_layout_rule("mean")
def _mean_rule(ctx, ins, attrs, lays):
    """The rank's sum over the whole value's count, summed over the split
    and partial axes (g): the mean, whole."""
    tpl = _tpl()
    x, lay = ins["X"][0], lays["X"][0]
    if not x.is_floating_point():
        return None
    out = x.sum() / _prod(tpl.global_shape(x.shape, lay, ctx.groups))
    for a in sorted(set(lay.split) | lay.partial):
        out = tpl.reduce(out, ctx.groups[a], a)
    return single(out), {}


def _reduce_rule(mean):
    def rule(ctx, ins, attrs, lays):
        """reduce_sum / reduce_mean: a reduced split dim makes the result
        partial, and it is summed (g) at once; a kept split dim stays
        split; a partial input stays partial (both are linear)."""
        tpl = _tpl()
        x, lay = ins["X"][0], lays["X"][0]
        if not x.is_floating_point():
            return None
        keep = attrs.get("keep_dim", False)
        dim = attrs.get("dim", None)
        if attrs.get("reduce_all", False) or dim is None:
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(sorted(d % x.dim() for d in dim))
        if not dims:
            return None
        if mean:
            gshape = tpl.global_shape(x.shape, lay, ctx.groups)
            out = x.sum(dim=dims, keepdim=keep) / _prod(
                gshape[d] for d in dims)
        else:
            out = LOWERINGS["reduce_sum"](ctx, ins, attrs)["Out"][0]
        split = {}
        for a, d in sorted(lay.split.items()):
            if d in dims:
                out = tpl.reduce(out, ctx.groups[a], a)
            else:
                split[a] = d if keep else d - sum(r < d for r in dims)
        return single(out), {"Out": [tpl.Layout(split, lay.partial)]}

    return rule


register_layout_rule("reduce_sum")(_reduce_rule(False))
register_layout_rule("reduce_mean")(_reduce_rule(True))


@register_layout_rule("scale")
def _scale_rule(ctx, ins, attrs, lays):
    """Elementwise; linear (a partial input stays partial) with no bias."""
    if ins.get("ScaleTensor") and not lays["ScaleTensor"][0].whole:
        return None
    linear = attrs.get("bias", 0.0) == 0.0
    return _tpl().unary(ctx, ins, attrs, lays, LOWERINGS["scale"],
                        linear=linear)


@register_layout_rule("isfinite")
def _isfinite_rule(ctx, ins, attrs, lays):
    """Every element of the whole value finite: the rank's flag, reduced
    by min over the split axes (the AMP skip gate reads it alike on every
    rank)."""
    tpl = _tpl()
    x, lay = tpl.resolve_partial(ctx, ins["X"][0], lays["X"][0])
    ok = torch.isfinite(x).all().to(torch.int32)
    for a in sorted(lay.split):
        ok = ctx.groups[a].all_reduce(ok, op="min")
    return single(ok.to(torch.bool)), {}
