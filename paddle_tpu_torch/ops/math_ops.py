"""Math op lowerings: elementwise_add, mul, matmul, mean.

Port of the paddle_tpu/ops/math_ops.py lowerings this slice runs. The
products go to ``torch.matmul``: they are plain matrix products that the
JAX package left to XLA, not Pallas kernels.
"""
import torch

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


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    x = ins["X"][0]
    y = _broadcast_y(x, ins["Y"][0], attrs.get("axis", -1))
    return single(x + y)


def _prod(t):
    r = 1
    for v in t:
        r *= int(v)
    return r


@register_op("mul")
def _mul(ctx, ins, attrs):
    """Flattening matmul (ref: paddle/fluid/operators/mul_op.cc): x is
    flattened to 2-D at x_num_col_dims, y at y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xnc]), _prod(xs[xnc:]))
    y2 = y.reshape(_prod(ys[:ync]), _prod(ys[ync:]))
    return single(torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
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
        out = out * alpha
    return single(out)


@register_op("mean")
def _mean(ctx, ins, attrs):
    return single(ins["X"][0].mean())
