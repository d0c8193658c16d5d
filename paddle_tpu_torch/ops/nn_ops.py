"""NN op lowerings: relu, sigmoid, log, exp, sqrt, square, floor, ceil,
cos, tanh, round, softmax, gelu, the 30 activations of
paddle_tpu/ops/nn_ops.py:37-166 (unary math, smooth, piecewise and
parametric activations, log_softmax), lookup_table_v2, conv2d,
depthwise_conv2d, pool2d, batch_norm, layer_norm, dropout.

Port of the paddle_tpu/ops/nn_ops.py lowerings the port runs.
``layer_norm`` always goes through ``LayerNorm`` (ops/cuda_layernorm.py),
whose forward and backward are the LayerNorm kernels on the card, for
every ``begin_norm_axis``: x is flattened to (prod(x.shape[:begin]),
prod(x.shape[begin:])). With autograd off (serving) the Function records
no graph and launches the same forward kernel. The JAX package reaches its Pallas kernel only behind
PADDLE_TPU_PALLAS_LN, because XLA fused the plain graph; the port has no
such compiler.

``conv2d`` is ``F.conv2d`` (cuDNN on the card): the reference computes it
with ``lax.conv_general_dilated``, outside Pallas, so it is a library call
here as a plain matrix product is ``torch.matmul``. ``pool2d`` and
``batch_norm`` follow the reference's arithmetic (its padding, divisors
and window rule; Paddle's running-statistics convention), which is not
torch's: see each lowering.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .cuda_layernorm import LayerNorm
from .detection_ops import jclip, jmax, jmin, scalar, table
from .registry import LOWERINGS, register_layout_rule, register_op, single
from .tensor_ops import linspace_f32


@register_op("relu")
def _relu(ctx, ins, attrs):
    return single(F.relu(ins["X"][0]))


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    """1 / (1 + exp(-x)), jax.nn.sigmoid; its gradient s·(1 - s)."""
    return single(torch.sigmoid(ins["X"][0]))


@register_op("log")
def _log(ctx, ins, attrs):
    return single(torch.log(ins["X"][0]))


def _unary(fn):
    def lower(ctx, ins, attrs):
        return single(fn(ins["X"][0]))

    return lower


# elementwise, in x's dtype, as the JAX lowerings compute them
register_op("exp")(_unary(torch.exp))
register_op("sqrt")(_unary(torch.sqrt))
register_op("square")(_unary(lambda x: x * x))
register_op("floor")(_unary(torch.floor))
register_op("ceil")(_unary(torch.ceil))
register_op("cos")(_unary(torch.cos))
register_op("tanh")(_unary(torch.tanh))


@register_op("round")
def _round(ctx, ins, attrs):
    """jnp.round: to the nearest integer, halves to even (torch.round's
    rule too), in x's dtype. The int8-resident decode step rounds its
    cache rows with it."""
    return single(torch.round(ins["X"][0]))


# ---------------------------------------------------------------------------
# the activation op types of activation_op.cc that paddle_tpu/ops/nn_ops.py
# lowers with jnp: each as the JAX lambda computes it, the piecewise ones
# with torch.where / maximum / minimum in the lambda's orientation, so the
# gradient at a kink is jax.vjp's: where() gives the whole cotangent to the
# branch it selects (x >= 0 selects x at 0), and jnp.clip is maximum then
# minimum, which split a tie's cotangent in halves (0.5 at a bound, not
# the 1 or 0 of F.relu6, F.hardtanh or torch.clamp): detection_ops' jclip,
# jmax and jmin, with their bounds made by fills (``scalar``)
# ---------------------------------------------------------------------------
def _act(fn):
    def lower(ctx, ins, attrs):
        return single(fn(ins["X"][0], attrs))

    return lower


def jax_softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), no threshold (F.softplus returns
    x above 20)."""
    return torch.logaddexp(x, scalar(0.0, x))


def _elu_neg(x, alpha):
    """alpha·(exp(min(x, 0)) - 1), elu's and selu's negative branch."""
    return alpha * (torch.exp(jmin(x, 0.0)) - 1)


register_op("rsqrt")(_act(lambda x, a: torch.rsqrt(x)))
register_op("reciprocal")(_act(lambda x, a: 1.0 / x))
register_op("sin")(_act(lambda x, a: torch.sin(x)))
register_op("tan")(_act(lambda x, a: torch.tan(x)))
register_op("asin")(_act(lambda x, a: torch.asin(x)))
register_op("acos")(_act(lambda x, a: torch.acos(x)))
register_op("atan")(_act(lambda x, a: torch.atan(x)))
register_op("sinh")(_act(lambda x, a: torch.sinh(x)))
register_op("cosh")(_act(lambda x, a: torch.cosh(x)))
register_op("erf")(_act(lambda x, a: torch.erf(x)))
# jax.nn.log_sigmoid is -softplus(-x)
register_op("logsigmoid")(_act(lambda x, a: -jax_softplus(-x)))
register_op("softplus")(_act(lambda x, a: jax_softplus(x)))
register_op("softsign")(_act(lambda x, a: x / (torch.abs(x) + 1)))
register_op("tanh_shrink")(_act(lambda x, a: x - torch.tanh(x)))
register_op("softshrink")(_act(lambda x, a: torch.where(
    x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
    torch.where(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5),
                scalar(0.0, x)))))
register_op("hard_shrink")(_act(lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, scalar(0.0, x))))
register_op("hard_sigmoid")(_act(lambda x, a: jclip(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0)))
register_op("hard_swish")(_act(lambda x, a: x * jclip(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0)))
register_op("relu6")(_act(lambda x, a: jclip(x, 0.0,
                                             a.get("threshold", 6.0))))
register_op("brelu")(_act(lambda x, a: jclip(x, a.get("t_min", 0.0),
                                             a.get("t_max", 24.0))))
register_op("leaky_relu")(_act(lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 0.02) * x)))
register_op("elu")(_act(lambda x, a: torch.where(
    x >= 0, x, _elu_neg(x, a.get("alpha", 1.0)))))
# jax's constants, as the JAX lowering writes them
register_op("selu")(_act(lambda x, a: a.get("scale", 1.0507009873554805)
                         * torch.where(x >= 0, x, _elu_neg(
                             x, a.get("alpha", 1.6732632423543772)))))
register_op("swish")(_act(lambda x, a: x * torch.sigmoid(
    a.get("beta", 1.0) * x)))
register_op("stanh")(_act(lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x)))
register_op("soft_relu")(_act(lambda x, a: torch.log(1 + torch.exp(jclip(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0))))))
register_op("thresholded_relu")(_act(lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, scalar(0.0, x))))


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    """The max over each group of C / groups consecutive channels of axis
    1: ``amax``, whose gradient splits among tied maxima as jnp.max's does
    (``max(dim)`` would send it to one index)."""
    x, groups = ins["X"][0], attrs["groups"]
    shape = (x.shape[0], groups, x.shape[1] // groups) + tuple(x.shape[2:])
    return single(x.reshape(shape).amax(dim=1))


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """where(x >= 0, x, alpha·x), Alpha one value (``all``), one a channel
    of axis 1 (``channel``) or one an element of x's trailing shape
    (``element``)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    return single(torch.where(x >= 0, x, alpha * x))


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return single(torch.log_softmax(ins["X"][0], dim=attrs.get("axis", -1)))


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    """softmax over ``axis``. In f32 ``torch.softmax``; in bfloat16 and
    float16 jax.nn.softmax's sequence, each op in x's dtype (the sum over
    f32 partials rounded once), as loss_ops.py does for log-softmax."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return single(torch.softmax(x, dim=axis))
    e = torch.exp(x - x.amax(dim=axis, keepdim=True).detach())
    return single(e / e.sum(dim=axis, keepdim=True))


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
    # F.embedding, not w[idx]: the indexing's backward (index_put_ with
    # accumulate) sums a repeated id's rows in another order on every CPU
    # run; the embedding backward sums them in one order
    out = F.embedding(idx.clamp(0, vocab - 1), w)
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


# ---------------------------------------------------------------------------
# conv / pool (ref: conv_op.cc, pool_op.cc)
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """XLA's SAME padding of one spatial dim (lax.padtype_to_pads): out =
    ceil(size / s), the shortfall split with the odd element on the high
    side."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_pads(x, w, strides, dilations, attrs):
    """((top, bottom), (left, right)) of the reference's conv2d: SAME,
    VALID, or explicit 2- or 4-element ``paddings``."""
    alg = attrs.get("padding_algorithm", "EXPLICIT")
    if alg == "SAME":
        return tuple(_same_pads(x.shape[2 + i], w.shape[2 + i], strides[i],
                                dilations[i]) for i in range(2))
    if alg == "VALID":
        return (0, 0), (0, 0)
    pads = _pair(attrs.get("paddings", [0, 0]))
    if len(pads) == 4:
        return (pads[0], pads[1]), (pads[2], pads[3])
    return (pads[0], pads[0]), (pads[1], pads[1])


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW data, OIHW filters. Sides padded alike go to the convolution;
    unequal ones (SAME with stride > 1, 4-element paddings) are padded
    with zeros first."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = _pair(attrs.get("strides", [1, 1]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1) or 1
    (top, bottom), (left, right) = _conv_pads(x, w, strides, dilations,
                                              attrs)
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
        padding = (0, 0)
    return {"Output": [F.conv2d(x, w, stride=strides, padding=padding,
                                dilation=dilations, groups=groups)]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


def _pool_window(x, ksize, strides, pads, ceil_mode, global_pool, adaptive):
    """(window, strides, ((low, high) per spatial dim)) by the reference's
    rule (paddle_tpu/ops/nn_ops.py ``_pool``), 2-D or 3-D: a global pool
    spans the
    input; an adaptive one takes stride in // out and window
    in - (out - 1)·stride (not torch's adaptive windows); ``ceil_mode``
    extends the high side far enough for ceil division."""
    in_hw = tuple(x.shape[2:])
    if global_pool:
        ksize, strides, pads = in_hw, in_hw, (0,) * len(in_hw)
    if adaptive:
        strides = tuple(i // o for i, o in zip(in_hw, ksize))
        ksize = tuple(i - (o - 1) * s
                      for i, o, s in zip(in_hw, ksize, strides))
        pads = (0,) * len(in_hw)
    sides = []
    for dim, k, s, p in zip(in_hw, ksize, strides, pads):
        hi = p
        if ceil_mode:
            out = -(-(dim + 2 * p - k) // s) + 1
            hi = p + max(0, (out - 1) * s + k - dim - 2 * p)
        sides.append((p, hi))
    return tuple(ksize), tuple(strides), tuple(sides)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """Max pooling pads with -inf; average pooling sums (zeros in the
    padding) and divides by the count of input elements in the window when
    ``exclusive``, else by prod(ksize), in f32 for a bfloat16 or float16
    x."""
    x = ins["X"][0]
    ksize, strides, ((top, bottom), (left, right)) = _pool_window(
        x, _pair(attrs.get("ksize", [2, 2])),
        _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])), attrs.get("ceil_mode", False),
        attrs.get("global_pooling", False), attrs.get("adaptive", False))
    pad4 = (left, right, top, bottom)
    if attrs.get("pooling_type", "max") == "max":
        if top == bottom and left == right and 2 * top <= ksize[0] \
                and 2 * left <= ksize[1]:
            # torch's own padding is -inf, within half a window
            return single(F.max_pool2d(x, ksize, strides, (top, left)))
        low = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        return single(F.max_pool2d(F.pad(x, pad4, value=low), ksize,
                                   strides))
    # a narrow x sums and divides in f32 and rounds once (the JAX
    # package's CPU run sums bfloat16 in bfloat16: ROADMAP.md, Queue 3)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    summed = F.avg_pool2d(F.pad(xf, pad4), ksize, strides,
                          divisor_override=1)
    if not attrs.get("exclusive", True):
        return single((summed / float(ksize[0] * ksize[1])).to(x.dtype))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=xf.dtype,
                      device=x.device)
    counts = F.avg_pool2d(F.pad(ones, pad4), ksize, strides,
                          divisor_override=1)
    return single((summed / counts).to(x.dtype))


# ---------------------------------------------------------------------------
# batch_norm (ref: batch_norm_op.cc)
# ---------------------------------------------------------------------------
@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """Paddle's batch norm, as the reference computes it, not
    ``F.batch_norm``: the batch statistics in f32 with the biased
    variance; the running ones updated as momentum·old + (1-momentum)·batch
    (torch's momentum is the other weight, its variance unbiased), from
    detached batch statistics, so the state carries no graph; Y in f32 as
    (x - mean)·(rsqrt(var + eps)·scale) + bias, cast to x's dtype (bfloat16
    conv outputs under AMP, with f32 Scale, Bias and statistics).
    SavedVariance is rsqrt(var + eps). With ``is_test`` or
    ``use_global_stats`` the running statistics normalize, pass through
    unchanged, and SavedMean / SavedVariance are zeros / ones.

    In a data-parallel run (``ctx.batch_stats_group``, set by
    ``DistributedProgram``) the training moments are the global batch's,
    as GSPMD gives them in the JAX package: each rank's sums over its
    slice are summed over the group (differentiably, so the backward
    reaches every rank's slice) and divided by the global count."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    ch = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]
    if attrs.get("use_global_stats", False) or is_test:
        use_var = var
        centered = x.float() - mean.float().reshape(bshape)
        new_mean, new_var = mean, var
        saved_mean, saved_var = torch.zeros_like(mean), torch.ones_like(var)
    else:
        # one f32 copy of x, centered, serves the variance and Y (and is
        # all autograd keeps of x for the backward)
        xf = x.float()
        group = ctx.batch_stats_group
        if group is not None and group.size > 1:
            from ..parallel.mesh import all_reduce_sum

            count = group.size * (xf.numel() // xf.shape[ch])
            use_mean = all_reduce_sum(xf.sum(dim=axes), group) / count
            centered = xf - use_mean.reshape(bshape)
            use_var = all_reduce_sum((centered * centered).sum(dim=axes),
                                     group) / count
        else:
            use_mean = xf.mean(dim=axes)
            centered = xf - use_mean.reshape(bshape)
            use_var = (centered * centered).mean(dim=axes)
        bm, bv = use_mean.detach(), use_var.detach()
        new_mean = momentum * mean + (1 - momentum) * bm
        new_var = momentum * var + (1 - momentum) * bv
        saved_mean, saved_var = use_mean, 1.0 / torch.sqrt(use_var + eps)
    inv = torch.rsqrt(use_var.float() + eps)
    y = centered * (inv * scale.float()).reshape(bshape) \
        + bias.float().reshape(bshape)
    return {
        "Y": [y.to(x.dtype)],
        "MeanOut": [new_mean.to(mean.dtype)],
        "VarianceOut": [new_var.to(var.dtype)],
        "SavedMean": [saved_mean],
        "SavedVariance": [saved_var],
    }


# ---------------------------------------------------------------------------
# 3-D convolution, transposed convolutions, pool3d (ref: conv_op.cc,
# conv_transpose_op.cc, pool_op.cc)
# ---------------------------------------------------------------------------
_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW data, OIDHW filters, each side padded by ``paddings``."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv3d(
        x, w, stride=_pair(attrs.get("strides", [1, 1, 1]), 3),
        padding=_pair(attrs.get("paddings", [0, 0, 0]), 3),
        dilation=_pair(attrs.get("dilations", [1, 1, 1]), 3),
        groups=attrs.get("groups", 1) or 1)]}


def _conv_transpose(ins, attrs, nd):
    """``lax.conv_transpose(..., transpose_kernel=True)`` with explicit
    padding (p, p - output_padding) per dim, as the reference lowers it:
    that padding applies to the stride-dilated input seen by the flipped
    kernel, so the output is ``F.conv_transpose`` with no padding (the
    full result, padded by k_eff - 1 on each side) cropped by
    k_eff - 1 - p low and k_eff - 1 - p + o high (a negative crop pads
    with zeros). That is torch's padding p only where p = (k_eff - 1) / 2
    and o = 0; elsewhere it is not the size the layer infers, as in the
    reference. Filters are (C_in, C_out, k...), torch's layout."""
    x, w = ins["Input"][0], ins["Filter"][0]
    if (attrs.get("groups", 1) or 1) != 1:
        raise NotImplementedError(
            "conv%dd_transpose groups>1: the reference lowering has no "
            "grouped mode — split channels and concat results, or use "
            "groups=1" % nd)
    strides = _pair(attrs.get("strides", [1] * nd), nd)
    pads = _pair(attrs.get("paddings", [0] * nd), nd)
    dilations = _pair(attrs.get("dilations", [1] * nd), nd)
    opad = _pair(attrs.get("output_padding", [0] * nd), nd)
    full = _CONV_T[nd](x, w, stride=strides, dilation=dilations)
    crop = []
    for i in reversed(range(nd)):          # F.pad lists the last dim first
        edge = dilations[i] * (w.shape[2 + i] - 1)
        crop += [pads[i] - edge, pads[i] - opad[i] - edge]
    return {"Output": [F.pad(full, crop)]}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 2)


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 3)


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """pool2d's rule over (D, H, W): max pads with -inf, average sums and
    divides by the window's count of input elements (``exclusive``) or
    by prod(ksize)."""
    x = ins["X"][0]
    ksize, strides, sides = _pool_window(
        x, _pair(attrs.get("ksize", [2, 2, 2]), 3),
        _pair(attrs.get("strides", [1, 1, 1]), 3),
        _pair(attrs.get("paddings", [0, 0, 0]), 3),
        attrs.get("ceil_mode", False), attrs.get("global_pooling", False),
        attrs.get("adaptive", False))
    pad6 = [p for side in reversed(sides) for p in side]
    if attrs.get("pooling_type", "max") == "max":
        low = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        return single(F.max_pool3d(F.pad(x, pad6, value=low), ksize,
                                   strides))
    summed = F.avg_pool3d(F.pad(x, pad6), ksize, strides, divisor_override=1)
    if not attrs.get("exclusive", True):
        return single(summed / float(ksize[0] * ksize[1] * ksize[2]))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool3d(F.pad(ones, pad6), ksize, strides,
                          divisor_override=1)
    return single(summed / counts)


# ---------------------------------------------------------------------------
# normalization (ref: group_norm_op.cc, instance_norm_op.cc, data_norm_op.cc,
# norm_op.cc, lrn_op.cc, spectral_norm_op.cc; the weight-norm pair of
# layer_helper_base.py)
# ---------------------------------------------------------------------------
def _moments(x, dims):
    """(mean, var) over `dims`, kept: jnp.mean and jnp.var (the biased
    variance, differentiated through its mean too)."""
    mean = x.mean(dim=dims, keepdim=True)
    centered = x - mean
    return mean, (centered * centered).mean(dim=dims, keepdim=True)


def _affine(out, ins, c):
    bshape = (1, c) + (1,) * (out.dim() - 2)
    if ins.get("Scale"):
        out = out * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(bshape)
    return out


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    """Each of ``groups`` channel groups normalized over its channels and
    spatial dims, then Scale and Bias per channel. Mean and Variance are
    (N, groups)."""
    x = ins["X"][0]
    g = attrs["groups"]
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    mean, var = _moments(xg, dims)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return {"Y": [_affine(out, ins, c)], "Mean": [mean.squeeze()],
            "Variance": [var.squeeze()]}


@register_op("instance_norm")
def _instance_norm(ctx, ins, attrs):
    """Each (sample, channel) normalized over its spatial dims."""
    x = ins["X"][0]
    mean, var = _moments(x, tuple(range(2, x.dim())))
    out = (x - mean) * torch.rsqrt(var + attrs.get("epsilon", 1e-5))
    return {"Y": [_affine(out, ins, x.shape[1])],
            "SavedMean": [mean.squeeze()], "SavedVariance": [var.squeeze()]}


@register_op("data_norm")
def _data_norm(ctx, ins, attrs):
    """(x - sum/size)·rsqrt(square_sum/size - mean² + 1e-4): the reference
    lowering's fixed 1e-4, not the ``epsilon`` attr."""
    x = ins["X"][0]
    size = ins["BatchSize"][0]
    mean = ins["BatchSum"][0] / size
    scale = torch.rsqrt(ins["BatchSquareSum"][0] / size - mean * mean + 1e-4)
    return {"Y": [(x - mean) * scale], "Means": [mean], "Scales": [scale]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    """x / sqrt(sum(x², axis) + eps), and that norm."""
    x = ins["X"][0]
    norm = torch.sqrt((x * x).sum(dim=attrs.get("axis", -1), keepdim=True)
                      + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


def _wn_norm(v, dim):
    """||v|| over every axis but `dim` (dim < 0: over all, shape (1,))."""
    if dim is None or dim < 0:
        return torch.sqrt((v * v).sum()).reshape(1)
    dims = tuple(a for a in range(v.dim()) if a != dim)
    return torch.sqrt((v * v).sum(dim=dims))


@register_op("norm_except_dim")
def _norm_except_dim(ctx, ins, attrs):
    """The weight-norm magnitude g seeded in startup as ||v||, so the
    first effective weight equals the initialised v."""
    return single(_wn_norm(ins["V"][0], attrs.get("dim", -1)))


@register_op("weight_norm_reparam")
def _weight_norm_reparam(ctx, ins, attrs):
    """w = g·v / ||v||, differentiable in g and v."""
    v, g = ins["V"][0], ins["G"][0]
    dim = attrs.get("dim", -1)
    norm = _wn_norm(v, dim)
    if dim is None or dim < 0:
        return single(v * (g[0] / norm[0]))
    bshape = [1] * v.dim()
    bshape[dim] = v.shape[dim]
    return single(v * (g / norm).reshape(bshape))


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """x / (k + alpha·Σ x²)^beta, the sum over n channels centred on each
    (zeros past the ends): alpha is not divided by n, unlike
    ``F.local_response_norm``."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    win = sq[:, 0:c]
    for i in range(1, n):
        win = win + sq[:, i:i + c]
    mid = torch.pow(attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * win,
                    attrs.get("beta", 0.75))
    return {"Out": [x / mid], "MidOut": [mid]}


@register_op("spectral_norm")
def _spectral_norm(ctx, ins, attrs):
    """Weight / sigma, sigma from ``power_iters`` power iterations that
    start at U and V (read, not updated), differentiated through the
    iterations as jax.vjp does."""
    w, u, v = ins["Weight"][0], ins["U"][0], ins["V"][0]
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    w2 = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(attrs.get("power_iters", 1)):
        v = w2.T @ u
        v = v / jmax(torch.linalg.vector_norm(v), eps)
        u = w2 @ v
        u = u / jmax(torch.linalg.vector_norm(u), eps)
    return single(w / (u @ (w2 @ v)))


# ---------------------------------------------------------------------------
# resampling (ref: interpolate_op.cc, grid_sampler_op.cc, affine_grid_op.cc,
# pixel_shuffle_op.cc, temporal_shift_op.cc)
# ---------------------------------------------------------------------------
def _nearest_index(m, n):
    """jax.image.resize's nearest source row of each of n outputs from m
    inputs: floor((i + 0.5)·m / n) in float32 (half-pixel centres, torch's
    ``nearest-exact``)."""
    return np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                    * np.float32(m) / np.float32(n)).astype(np.int64)


def _linear_weights(m, n):
    """jax.image.scale_and_translate's (m, n) triangle-kernel weights for
    resizing m samples to n, in float32 as it computes them: the kernel
    widened by m / n when shrinking (antialiasing), each column divided
    by its sum, and columns whose sample lies outside the input zeroed."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.0) \
        - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(x, out_sizes, method):
    """``jax.image.resize`` of x's trailing len(out_sizes) dims: nearest by
    gathering rows, linear by contracting each resized dim with its
    weight matrix (dims whose size does not change are left alone)."""
    lead = x.dim() - len(out_sizes)
    for i, n in enumerate(out_sizes):
        d = lead + i
        m = x.shape[d]
        if m == n:
            continue
        if method == "nearest":
            idx = table(_nearest_index(m, n), x.device, torch.long)
            x = x.index_select(d, idx)
        else:
            w = table(_linear_weights(m, n), x.device, x.dtype)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _interp(ins, attrs, method):
    """(N, C, H, W) to (out_h, out_w): from OutSize (read on the host),
    else ``scale`` (int(H·scale)), else the attrs. ``align_corners`` and
    ``align_mode`` are not read, as in the reference."""
    x = ins["X"][0]
    out_h, out_w = attrs.get("out_h", -1), attrs.get("out_w", -1)
    scale = attrs.get("scale", 0.0)
    if ins.get("OutSize"):
        out_h, out_w = (int(v) for v in ins["OutSize"][0].tolist()[:2])
    elif scale and scale > 0:
        out_h, out_w = int(x.shape[2] * scale), int(x.shape[3] * scale)
    return single(_resize(x, (out_h, out_w), method))


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    return _interp(ins, attrs, "linear")


@register_op("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    return _interp(ins, attrs, "nearest")


@register_op("trilinear_interp")
def _trilinear_interp(ctx, ins, attrs):
    """(N, C, D, H, W) to the attrs' (out_d, out_h, out_w)."""
    return single(_resize(ins["X"][0], (attrs.get("out_d", -1),
                                        attrs.get("out_h", -1),
                                        attrs.get("out_w", -1)), "linear"))


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear samples of X at Grid's (x, y) in [-1, 1], mapped as
    (g + 1)·(size - 1)/2 (torch's ``align_corners=True``); the four
    neighbours' indices are clamped into the image while the weights keep
    the unclamped position, as the reference computes them."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    wx = (gx - x0f)[..., None]
    wy = (gy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(xi, yi):            # (N, oh, ow, C)
        return x[bidx, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    out = (sample(x0, y0) * (1 - wx) * (1 - wy)
           + sample(x0 + 1, y0) * wx * (1 - wy)
           + sample(x0, y0 + 1) * (1 - wx) * wy
           + sample(x0 + 1, y0 + 1) * wx * wy)
    return {"Output": [torch.movedim(out, -1, 1)]}


@register_op("affine_grid")
def _affine_grid(ctx, ins, attrs):
    """(N, H, W, 2) sampling grid: Theta (N, 2, 3) applied to (x, y, 1)
    over ``linspace(-1, 1)`` of W and H. An OutputShape tensor is read on
    the host."""
    theta = ins["Theta"][0]
    if ins.get("OutputShape"):
        oshape = [int(v) for v in ins["OutputShape"][0].tolist()]
    else:
        oshape = attrs["output_shape"]
    h, w = int(oshape[2]), int(oshape[3])
    ys = table(linspace_f32(-1.0, 1.0, h), theta.device, theta.dtype)
    xs = table(linspace_f32(-1.0, 1.0, w), theta.device, theta.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (h, w, 3)
    return {"Output": [torch.einsum("hwk,njk->nhwj", base, theta)]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = attrs["upscale_factor"]
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return single(x.reshape(n, c // (r * r), h * r, w * r))


@register_op("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    """Within each of the N/seg_num clips, the first C·ratio channels
    move one step back in time, the next C·ratio one step forward (zeros
    at the ends), the rest stay."""
    x = ins["X"][0]
    seg = attrs["seg_num"]
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg, seg, c, h, w)
    c1 = int(c * attrs.get("shift_ratio", 0.25))
    fwd = F.pad(x[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    back = F.pad(x[:, :-1, c1:2 * c1], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([fwd, back, x[:, :, 2 * c1:]], dim=2)
    return single(out.reshape(nt, c, h, w))


@register_op("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """alpha·x + beta·[sin | cos](t / 10000^(2i/d)) over (B, T, d), the
    table in float32 as the reference computes it."""
    x = ins["X"][0]
    _, t, d = x.shape
    f32 = np.float32
    pos = np.arange(t)[:, None].astype(f32)
    expo = (2 * np.arange(d // 2)[None, :]).astype(f32) / f32(d)
    angle = pos / np.power(f32(10000.0), expo)
    pe = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(f32)
    return single(attrs.get("alpha", 1.0) * x
                  + attrs.get("beta", 1.0) * table(pe, x.device, x.dtype)[None])


# ---------------------------------------------------------------------------
# layout rules under tensor and sequence parallelism
# (parallel/tensor_parallel.py)
# ---------------------------------------------------------------------------
def _tpl():
    from ..parallel import tensor_parallel

    return tensor_parallel


def _elementwise_rule(ctx, ins, attrs, lays):
    """An activation runs on the rank's block; a partial input is summed
    first."""
    return _tpl().unary(ctx, ins, attrs, lays,
                        LOWERINGS[ctx.current_op.type])


register_layout_rule(
    "relu", "sigmoid", "tanh", "gelu", "exp", "sqrt", "square", "log",
    "floor", "ceil", "cos", "sin", "erf", "rsqrt", "reciprocal", "softplus",
    "softsign", "leaky_relu", "elu", "relu6", "swish", "hard_swish",
    "hard_sigmoid", "logsigmoid", "abs", "sign")(_elementwise_rule)


@register_layout_rule("softmax")
def _softmax_rule(ctx, ins, attrs, lays):
    """Over a dim that is not split: on the rank's block."""
    x, lay = ins["X"][0], lays["X"][0]
    if lay.axis_on(attrs.get("axis", -1) % x.dim()) is not None:
        return None
    return _tpl().unary(ctx, ins, attrs, lays, LOWERINGS["softmax"])


@register_layout_rule("dropout")
def _dropout_rule(ctx, ins, attrs, lays):
    """On a split value: the keep mask of the whole value drawn from the
    run's generator (the draw the one-device run makes), the rank's block
    kept."""
    tpl = _tpl()
    x, lay = tpl.resolve_partial(ctx, ins["X"][0], lays["X"][0])
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        out = LOWERINGS["dropout"](ctx, {"X": [x]}, attrs)
        return out, {"Out": [lay], "Mask": [lay]}
    keep_prob = 1.0 - p
    keep = tpl.rng_block(ctx, x.shape, lay, lambda shape: torch.rand(
        shape, generator=ctx.next_rng(), device=x.device)) < keep_prob
    if impl == "upscale_in_train":
        x = x / max(keep_prob, 1e-8)
    out = x.masked_fill(~keep, 0.0)
    return ({"Out": [out], "Mask": [keep.to(out.dtype)]},
            {"Out": [lay], "Mask": [lay]})


@register_layout_rule("layer_norm")
def _layer_norm_rule(ctx, ins, attrs, lays):
    """Split on the rows (dims before ``begin_norm_axis``): the kernel
    normalizes the rank's rows, the scale and bias entered whole (f)."""
    tpl = _tpl()
    x, lay = tpl.resolve_partial(ctx, ins["X"][0], lays["X"][0])
    begin = attrs.get("begin_norm_axis", 1)
    if any(d >= begin for d in lay.split.values()):
        return None
    ins = dict(ins, X=[x])
    for slot in ("Scale", "Bias"):
        if ins.get(slot):
            if not lays[slot][0].whole:
                return None
            v = ins[slot][0]
            for a in sorted(lay.split):
                v = tpl.enter(v, ctx.groups[a], a)
            ins[slot] = [v]
    out = LOWERINGS["layer_norm"](ctx, ins, attrs)
    stats = lay if out["Mean"][0].dim() == begin else None
    if stats is None:
        out["Mean"], out["Variance"] = [None], [None]
    return out, {"Y": [lay], "Mean": [stats], "Variance": [stats]}


@register_layout_rule("lookup_table_v2")
def _lookup_rule(ctx, ins, attrs, lays):
    """A table split on its rows (the vocabulary): each rank looks up the
    ids in its rows, zeros elsewhere, and the lookups are summed (g). A
    table split on its columns gives rows split there. Ids split over an
    axis give rows split alike (the table entered whole over it)."""
    tpl = _tpl()
    w, ids = ins["W"][0], ins["Ids"][0]
    lw, li = lays["W"][0], lays["Ids"][0]
    if lw.partial or li.partial:
        return None
    squeeze = (ids.dim() >= 2 and ids.shape[-1] == 1
               and attrs.get("_squeeze", True))
    nd = ids.dim() - 1 if squeeze else ids.dim()
    if squeeze and li.axis_on(ids.dim() - 1) is not None:
        return None
    split = dict(li.split)
    for a in sorted(set(li.split) - set(lw.split)):
        w = tpl.enter(w, ctx.groups[a], a)
    rows = None
    for a, d in sorted(lw.split.items()):
        if a in li.split:
            return None
        if d == 0:
            rows = a
        else:
            split[a] = nd
    if rows is None:
        out = LOWERINGS["lookup_table_v2"](ctx, dict(ins, W=[w]), attrs)
        return out, {"Out": [tpl.Layout(split)]}
    g = ctx.groups[rows]
    if squeeze:
        ids = ids[..., 0]
    per = w.shape[0]
    vocab = per * g.size
    lo = g.rank * per
    idx = torch.where(ids < 0, ids + vocab, ids)
    mine = (idx >= lo) & (idx < lo + per)
    out = F.embedding((idx - lo).clamp(0, per - 1), w)
    out = out * mine[..., None].to(out.dtype)
    out = tpl.reduce(out, g, rows)
    valid = (idx >= 0) & (idx < vocab)
    out = torch.where(valid[..., None], out,
                      torch.full((), float("nan"), dtype=w.dtype,
                                 device=w.device))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return single(out), {"Out": [tpl.Layout(split)]}
