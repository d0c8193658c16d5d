"""NN op lowerings: relu, sigmoid, log, round, softmax, gelu, lookup_table_v2,
conv2d, depthwise_conv2d, pool2d, batch_norm, layer_norm, dropout.

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
import torch
import torch.nn.functional as F

from .cuda_layernorm import LayerNorm
from .registry import register_op, single


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


@register_op("round")
def _round(ctx, ins, attrs):
    """jnp.round: to the nearest integer, halves to even (torch.round's
    rule too), in x's dtype. The int8-resident decode step rounds its
    cache rows with it."""
    return single(torch.round(ins["X"][0]))


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
    """(window, strides, ((top, bottom), (left, right))) by the reference's
    rule (paddle_tpu/ops/nn_ops.py ``_pool``): a global pool spans the
    input; an adaptive one takes stride in // out and window
    in - (out - 1)·stride (not torch's adaptive windows); ``ceil_mode``
    extends the high side far enough for ceil division."""
    in_hw = tuple(x.shape[2:])
    if global_pool:
        ksize, strides, pads = in_hw, in_hw, (0, 0)
    if adaptive:
        strides = tuple(i // o for i, o in zip(in_hw, ksize))
        ksize = tuple(i - (o - 1) * s
                      for i, o, s in zip(in_hw, ksize, strides))
        pads = (0, 0)
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
    unchanged, and SavedMean / SavedVariance are zeros / ones."""
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
