"""Misc op lowerings, port of paddle_tpu/ops/misc_ops.py: py_func,
similarity_focus, the selected-rows pair, deformable_psroi_pooling,
tree_conv, isinf_any, isnan_any, shard_index, hash, row_conv, unfold,
im2sequence, cvm, fsp, warpctc, space_to_depth, affine_channel, and the
two loss ops nce and hierarchical_sigmoid (ref: paddle/fluid/operators/
{py_func,similarity_focus,deformable_psroi_pooling,tree_conv,shard_index,
hash,row_conv,unfold,im2sequence,cvm,fsp,warpctc,space_to_depth,
affine_channel,nce,hierarchical_sigmoid}_op.*).

``warpctc`` is the reference's dense log-domain forward algorithm, a
Python loop of T - 1 steps on device tensors differentiated by autograd,
with jax's ``logaddexp`` derivative (:class:`JaxLogAddExp`): not
``F.ctc_loss``, whose values and gradients differ where no alignment is
feasible and which has no frozen steps past LogitsLength.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .detection_ops import jclip, jmax, roi_batch_idx, scalar
from .loss_ops import _f32_log, gather_rows, uniform_samples
from .nn_ops import jax_softplus
from .registry import register_op, single


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform negatives, as the
    reference computes it: ``num_neg_samples`` class ids drawn from the
    run's generator (one set for the batch); the true class's logit x·w
    (+ b) and the negatives' x·wᵀ (+ b), each less log(num_neg / classes);
    Cost = softplus(-true) + the sum of softplus(negatives), (B, 1). The
    first label column is the true class (a label out of range clamps, as
    jax's gather does)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    num_neg = attrs.get("num_neg_samples", 10)
    n_classes = attrs["num_total_classes"]
    lab = ins["Label"][0]
    if lab.dim() == 1:
        lab = lab[:, None]
    neg = uniform_samples(ctx, num_neg, n_classes, x.device)
    true_logit = (x * gather_rows(w, lab[:, 0])).sum(dim=-1)
    if b is not None:
        true_logit = true_logit + gather_rows(b, lab[:, 0])[:, 0]
    neg_logit = x @ w[neg].T
    if b is not None:
        neg_logit = neg_logit + b[neg, 0][None, :]
    logq = _f32_log(num_neg / n_classes)
    cost = jax_softplus(-(true_logit - logq)) + jax_softplus(
        neg_logit - logq).sum(dim=-1)
    return {"Cost": [cost[:, None]]}


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """The default complete binary tree's hierarchical sigmoid: the leaf of
    label l sits at heap position l + C (1-indexed); for each of the
    ceil(log2 C) levels the internal node (position >> d) - 1 (clipped to
    W's rows) scores x·w (+ b), and softplus(∓logit) by the direction bit
    (position >> (d - 1)) & 1 adds to the loss where the node exists.
    The shifts run on int64."""
    x, w = ins["X"][0], ins["W"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    num_classes = attrs["num_classes"]
    depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    lab = ins["Label"][0].long()
    if lab.dim() == 2:
        lab = lab[:, 0]
    code = lab + num_classes
    zero = scalar(0.0, x)
    loss = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for d in range(depth, 0, -1):
        parent = code >> d
        bit = (code >> (d - 1)) & 1
        nid = (parent - 1).clamp(0, w.shape[0] - 1)
        logit = (x * w[nid]).sum(dim=-1)
        if b is not None:
            logit = logit + b[nid, 0]
        step = jax_softplus(torch.where(bit == 1, -logit, logit))
        loss = loss + torch.where(parent >= 1, step, zero)
    return {"Out": [loss[:, None]]}


# ---------------------------------------------------------------------------
# py_func (ref: py_func_op.cc)
# ---------------------------------------------------------------------------
def _host(t):
    return t.detach().cpu().numpy()


def _call_host(func, xs, shapes, dtypes, device):
    """func on the inputs' values as host numpy; its results (the inputs
    themselves when it returns None, a printing function) as tensors of
    the declared shapes and dtypes on the run's `device`."""
    arrays = [_host(x) for x in xs]
    res = func(*arrays)
    if res is None:
        res = arrays[:len(shapes)]
    if not isinstance(res, (tuple, list)):
        res = (res,)
    return [torch.from_numpy(np.ascontiguousarray(
        np.asarray(r, dtype=d).reshape(s))).to(device)
        for r, s, d in zip(res, shapes, dtypes)]


class _PyFunc(torch.autograd.Function):
    """The host function as one autograd node, its backward
    ``backward_func`` called the same way with the reference's argument
    order (x..., out..., dout..., less ``skip_vars_in_backward_input``)."""

    @staticmethod
    def forward(ctx, spec, *xs):
        func, _, _, shapes, dtypes, _, device = spec
        outs = _call_host(func, xs, shapes, dtypes, device)
        ctx.spec = spec
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        _, backward_func, skip, _, _, (x_names, out_names), _ = ctx.spec
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        args = [_host(x) for n, x in zip(x_names, xs) if n not in skip]
        args += [_host(o) for n, o in zip(out_names, outs) if n not in skip]
        args += [_host(torch.zeros_like(o) if g is None else g)
                 for g, o in zip(gouts, outs)]
        res = backward_func(*args)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = list(res) + [None] * (len(xs) - len(res))
        grads = []
        for r, x in zip(res, xs):
            if not x.is_floating_point():
                grads.append(None)
            elif r is None:
                grads.append(torch.zeros_like(x))
            else:
                grads.append(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(r, dtype=_host(x).dtype).reshape(
                        x.shape))).to(x.device))
        return (None,) + tuple(grads)


@register_op("py_func")
def _py_func(ctx, ins, attrs):
    """A Python function on the host (``fluid.layers.py_func``): the
    inputs' values copied to numpy, the results back to the run's device
    at the declared shapes (-1 is the first input's batch) and dtypes.
    With a ``backward_func`` its gradient is that function's; without one
    the outputs carry no gradient, as the reference's callback has no
    VJP."""
    from ..fluid.layers.nn import _PY_FUNC_REGISTRY

    func, backward_func, skip = _PY_FUNC_REGISTRY[attrs["func_id"]]
    xs = list(ins["X"])
    batch = xs[0].shape[0] if xs and xs[0].dim() else 1
    shapes = [tuple(batch if d == -1 else d for d in s)
              for s in attrs["out_shapes"]]
    dtypes = [np.dtype(d) for d in attrs["out_dtypes"]]
    if backward_func is None:
        return {"Out": _call_host(func, xs, shapes, dtypes, ctx.device)}
    spec = (func, backward_func, skip, shapes, dtypes,
            (attrs["x_names"], attrs["out_names"]), ctx.device)
    return {"Out": list(_PyFunc.apply(spec, *xs))}


# ---------------------------------------------------------------------------
# similarity_focus, the selected-rows pair (ref: similarity_focus_op.h,
# merge_selected_rows_op, get_tensor_from_selected_rows_op)
# ---------------------------------------------------------------------------
@register_op("similarity_focus")
def _similarity_focus(ctx, ins, attrs):
    """For each channel of ``indexes`` along ``axis``: min(B', C') greedy
    maxima of the (B', C') slice with distinct rows and columns (ties to
    the first in row-major order), marked 1; the masks OR'd over the
    indexes and broadcast over the focus axis."""
    x = ins["X"][0]
    axis = attrs["axis"]
    n = x.shape[0]
    perm = [0, axis] + [d for d in range(1, 4) if d != axis]
    xt = x.permute(perm)
    b_, c_ = xt.shape[2], xt.shape[3]
    rows = torch.arange(n, device=x.device)
    r_ar = torch.arange(b_, device=x.device)[None, :, None]
    c_ar = torch.arange(c_, device=x.device)[None, None, :]
    ninf = torch.full((), float("-inf"), device=x.device)
    total = torch.zeros((n, b_, c_), device=x.device)
    for ind in attrs["indexes"]:
        cur = xt[:, int(ind)].float()
        mask = torch.zeros((n, b_, c_), device=x.device)
        for _ in range(min(b_, c_)):
            flat = torch.argmax(cur.reshape(n, -1), dim=1)
            ri, ci = flat // c_, flat % c_
            mask = mask.index_put((rows, ri, ci), torch.ones_like(
                ri, dtype=mask.dtype))
            cur = torch.where(r_ar == ri[:, None, None], ninf, cur)
            cur = torch.where(c_ar == ci[:, None, None], ninf, cur)
        total = torch.maximum(total, mask)
    out = total[:, None].expand(xt.shape).to(x.dtype)
    inv = [0] * 4
    for i, d in enumerate(perm):
        inv[d] = i
    return single(out.permute(inv))


@register_op("merge_selected_rows")
def _merge_selected_rows(ctx, ins, attrs):
    """Identity: gradients are dense tensors here, their repeated rows
    already summed (the reference's SelectedRows merge)."""
    return single(ins["X"][0])


@register_op("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    """Identity: a dense tensor already."""
    return single(ins["X"][0])


# ---------------------------------------------------------------------------
# deformable_psroi_pooling (ref: deformable_psroi_pooling_op.h)
# ---------------------------------------------------------------------------
@register_op("deformable_psroi_pooling")
def _deformable_psroi_pooling(ctx, ins, attrs):
    """Each ROI's (ph, pw) bins average sample_per_part² bilinear taps,
    each shifted by Trans (part-indexed, times trans_std and the ROI's
    size); a tap outside the image is left out of the average (the
    count), one inside is clamped to the image. position_sensitive picks
    channel o·gh·gw + gi·gw + gj for output channel o at group cell
    (gi, gj); otherwise the first output_dim channels. Vectorized over the
    ROIs: the reference vmaps one ROI."""
    x, rois = ins["Input"][0], ins["ROIs"][0]
    trans = ins["Trans"][0] if ins.get("Trans") else None
    bidx = roi_batch_idx(ins, rois.shape[0], x.device)
    scale = attrs.get("spatial_scale", 1.0)
    out_c = attrs.get("output_dim")
    group = attrs.get("group_size", [1, 1])
    ph, pw = attrs.get("pooled_height", 1), attrs.get("pooled_width", 1)
    part = attrs.get("part_size", [ph, pw])
    spp = max(attrs.get("sample_per_part", 1), 1)
    trans_std = attrs.get("trans_std", 0.1)
    _, c_in, h, w = x.shape
    gh, gw = group if isinstance(group, (list, tuple)) else [group] * 2
    part_h, part_w = part if isinstance(part, (list, tuple)) else [part] * 2
    dev = x.device
    ii = torch.arange(ph, device=dev)[:, None]
    jj = torch.arange(pw, device=dev)[None, :]

    def col(k):
        return rois[:, k][:, None, None]

    x1, y1 = col(0) * scale - 0.5, col(1) * scale - 0.5
    x2, y2 = col(2) * scale + 0.5, col(3) * scale + 0.5
    rh, rw = jmax(y2 - y1, 0.1), jmax(x2 - x1, 0.1)
    bin_h, bin_w = rh / ph, rw / pw
    if attrs.get("no_trans", False) or trans is None:
        dy = dx = torch.zeros((ph, pw), dtype=x.dtype, device=dev)
    else:
        pi = ((ii * part_h) // ph).clamp(0, part_h - 1)
        pj = ((jj * part_w) // pw).clamp(0, part_w - 1)
        dy = trans[:, 0][:, pi, pj] * trans_std * rh
        dx = trans[:, 1][:, pi, pj] * trans_std * rw
    ridx = bidx[:, None, None]

    def at(yy, xx):                          # (R, ph, pw, C)
        return x[ridx, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    acc = cnt = 0
    for sy in range(spp):
        for sx in range(spp):
            py = y1 + ii * bin_h + (sy + 0.5) * bin_h / spp + dy
            px = x1 + jj * bin_w + (sx + 0.5) * bin_w / spp + dx
            ok = ((py > -1) & (py < h) & (px > -1) & (px < w)).to(x.dtype)
            py, px = jclip(py, 0.0, h - 1.0), jclip(px, 0.0, w - 1.0)
            y0f, x0f = torch.floor(py), torch.floor(px)
            wy, wx = (py - y0f)[..., None], (px - x0f)[..., None]
            y0, x0 = y0f.long(), x0f.long()
            val = (at(y0, x0) * (1 - wy) * (1 - wx)
                   + at(y0, x0 + 1) * (1 - wy) * wx
                   + at(y0 + 1, x0) * wy * (1 - wx)
                   + at(y0 + 1, x0 + 1) * wy * wx)
            acc = acc + val * ok[..., None]
            cnt = cnt + ok
    acc = (acc / jmax(cnt, 1.0)[..., None]).permute(0, 3, 1, 2)
    if not attrs.get("position_sensitive", True):
        return {"Output": [acc[:, :out_c]]}
    gi = ((ii * gh) // ph).clamp(0, gh - 1)
    gj = ((jj * gw) // pw).clamp(0, gw - 1)
    chan = (torch.arange(out_c, device=dev)[:, None, None] * gh * gw
            + gi[None] * gw + gj[None])
    r4 = torch.arange(rois.shape[0], device=dev)[:, None, None, None]
    return {"Output": [acc[r4, chan[None], ii[None, None], jj[None, None]]]}


# ---------------------------------------------------------------------------
# tree_conv (ref: tree_conv_op.h, math/tree2col.cc)
# ---------------------------------------------------------------------------
@register_op("tree_conv")
def _tree_conv(ctx, ins, attrs):
    """TBCNN tree convolution as the reference formulates it: per graph,
    max_depth reachability products (reach_{d+1} = reach_d @ A) weight
    each node's features by (eta_l, eta_r, eta_t) of its depth below the
    patch root and its place among its siblings (edge-row order); the
    (B, N, 3F) patches times Filter (F, 3, S, M) give (B, N, S, M).
    EdgeSet rows are 1-indexed (parent, child); a zero row is padding."""
    nodes = ins["NodesVector"][0]
    edges = ins["EdgeSet"][0].long()
    w = ins["Filter"][0]
    max_depth = int(attrs.get("max_depth", 2))
    b, n, f = nodes.shape
    e = edges.shape[1]
    fs, _, s_out, m_out = w.shape
    dev, dt = nodes.device, nodes.dtype
    ar = torch.arange(e, device=dev)
    patches = []
    for g in range(b):
        parent, child = edges[g, :, 0], edges[g, :, 1]
        valid = (parent > 0) & (child > 0)
        dump = torch.full_like(parent, n)
        p0 = torch.where(valid, parent - 1, dump)
        c0 = torch.where(valid, child - 1, dump)
        one, zero = scalar(1.0, nodes), scalar(0.0, nodes)
        adj = torch.zeros((n + 1, n + 1), dtype=dt, device=dev).index_put(
            (p0, c0), torch.where(valid, one, zero))[:n, :n]
        same = ((parent[None, :] == parent[:, None]) & valid[None, :]
                & valid[:, None])
        index_e = 1.0 + (same & (ar[None, :] < ar[:, None])).sum(dim=1).to(dt)
        pclen_e = same.sum(dim=1).to(dt)
        base = torch.ones((n + 1,), dtype=dt, device=dev)
        idx_n = base.index_put((c0,), torch.where(valid, index_e, one))[:n]
        pcl_n = base.index_put((c0,), torch.where(valid, pclen_e, one))[:n]
        out = torch.zeros((n, f * 3), dtype=dt, device=dev)
        reach = torch.eye(n, dtype=dt, device=dev)
        feat = nodes[g]
        for d in range(max_depth):
            eta_t = (max_depth - d) / max_depth
            if d == 0:
                lfac = torch.full((n,), 0.5, dtype=dt, device=dev)
            else:
                lfac = torch.where(pcl_n == 1.0, scalar(0.5, nodes),
                                   (idx_n - 1.0) / jmax(pcl_n - 1.0, 1.0))
            eta_l = (1.0 - eta_t) * lfac
            eta_r = (1.0 - eta_t) * (1.0 - eta_l)
            coefs = torch.stack([eta_l, eta_r, torch.full(
                (n,), eta_t, dtype=dt, device=dev)], dim=1)
            weighted = feat[:, :, None] * coefs[:, None, :]
            out = out + reach @ weighted.reshape(n, f * 3)
            reach = reach @ adj
        patches.append(out)
    patches = torch.stack(patches)
    out = patches.reshape(b, n, fs * 3) @ w.reshape(fs * 3, s_out * m_out)
    return single(out.reshape(b, n, s_out, m_out))


# ---------------------------------------------------------------------------
# small ops (ref: isfinite_op, shard_index_op, hash_op, row_conv_op,
# unfold_op, im2sequence_op, cvm_op, fsp_op, space_to_depth_op,
# affine_channel_op)
# ---------------------------------------------------------------------------
@register_op("isinf_any")
def _isinf_any(ctx, ins, attrs):
    return single(torch.isinf(ins["X"][0]).any())


@register_op("isnan_any")
def _isnan_any(ctx, ins, attrs):
    return single(torch.isnan(ins["X"][0]).any())


@register_op("shard_index")
def _shard_index(ctx, ins, attrs):
    """x mod the shard size where x // size is ``shard_id``, else
    ``ignore_value`` (floor division and remainder, Python's rule)."""
    x = ins["X"][0]
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    keep = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return single(torch.where(keep, torch.remainder(x, size),
                              scalar(attrs.get("ignore_value", -1), x)))


_U32 = 0xFFFFFFFF
_MULT = 2654435761


def _mul_u32(x, c):
    """x·c mod 2**32 for x in [0, 2**32) in int64, the product taken in
    16-bit halves so no intermediate passes 2**48."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * c) & 0xFFFF) * 65536) & _U32


@register_op("hash")
def _hash(ctx, ins, attrs):
    """The reference's multiplicative hash on x as uint32: h = x·2654435761
    + 0x9E3779B9·(i + 1) mod 2**32, h ^= h >> 16, h mod ``mod_by``, int64
    (stacked on axis -2 for several hashes). The uint32 arithmetic runs in
    int64 with masks. As in the reference, ``num_hash`` > 1 raises: its
    second constant does not fit in uint32."""
    x = ins["X"][0].long() & _U32
    mod_by = attrs["mod_by"]
    outs = []
    for i in range(attrs.get("num_hash", 1)):
        c = 0x9E3779B9 * (i + 1)
        if c > _U32:
            raise OverflowError(
                "hash: the constant 0x9E3779B9 * %d = %d is out of bounds "
                "for uint32, as in the reference lowering (num_hash must be "
                "1)" % (i + 1, c))
        h = (_mul_u32(x, _MULT) + c) & _U32
        h = h ^ (h >> 16)
        outs.append(torch.remainder(h, mod_by))
    return single(torch.stack(outs, dim=-2) if len(outs) > 1 else outs[0])


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution over (B, T, D): out[t] = Σ_i x[t + i]·w[i]
    for the ctx + 1 rows of Filter, zeros past the end."""
    x, w = ins["X"][0], ins["Filter"][0]
    out = torch.zeros_like(x)
    for i in range(w.shape[0]):
        shifted = F.pad(x[:, i:, :], (0, 0, 0, i))
        out = out + shifted * w[i][None, None, :]
    return single(out)


@register_op("unfold")
def _unfold(ctx, ins, attrs):
    """(N, C·kh·kw, L) patches, channel-major as
    ``lax.conv_general_dilated_patches`` orders them; ``paddings`` of 4
    are [(p0, p1) on H, (p2, p3) on W], as the reference reads them."""
    x = ins["X"][0]
    pd = list(attrs["paddings"])
    if len(pd) == 2:
        pd = [pd[0], pd[0], pd[1], pd[1]]
    x = F.pad(x, (pd[2], pd[3], pd[0], pd[1]))
    return {"Y": [F.unfold(x, tuple(attrs["kernel_sizes"]),
                           dilation=tuple(attrs["dilations"]),
                           stride=tuple(attrs["strides"]))]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """(N·L, C·kh·kw) rows: each image's VALID patches in row-major order,
    channel-major within a patch. ``paddings`` is not read, as in the
    reference."""
    x = ins["X"][0]
    patches = F.unfold(x, tuple(attrs["kernels"]),
                       stride=tuple(attrs["strides"]))
    return single(patches.transpose(1, 2).reshape(-1, patches.shape[1]))


@register_op("cvm")
def _cvm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Y": [x if attrs.get("use_cvm", True) else x[:, 2:]]}


@register_op("fsp")
def _fsp(ctx, ins, attrs):
    """(N, Cx, Cy) = X·Yᵀ over the H·W positions, divided by H·W."""
    x, y = ins["X"][0], ins["Y"][0]
    n, hw = x.shape[0], x.shape[2] * x.shape[3]
    return single(torch.einsum("nch,ndh->ncd", x.reshape(n, x.shape[1], hw),
                               y.reshape(n, y.shape[1], hw)) / hw)


@register_op("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = ins["X"][0]
    b = attrs["blocksize"]
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return single(x.reshape(n, c * b * b, h // b, w // b))


@register_op("affine_channel")
def _affine_channel(ctx, ins, attrs):
    """x·Scale + Bias per channel (axis 1, or the last with NHWC)."""
    x = ins["X"][0]
    ch = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]
    out = x
    if ins.get("Scale"):
        out = out * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(bshape)
    return single(out)


# ---------------------------------------------------------------------------
# warpctc (ref: warpctc_op.cc)
# ---------------------------------------------------------------------------
class JaxLogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with jax's derivative. The value is
    ``torch.logaddexp``'s, the same max + log1p(exp(-|a - b|)) (a where a
    and b are the same infinity, as jax's a + b), one kernel. The
    derivative is jax's, g·exp(a - out) and g·exp(b - out) with
    infinities read as 0: torch.logaddexp's own, g / (1 + exp(b - a)),
    differs where both sides sit at the -1e30 floor of an infeasible
    alignment, where out rounds to the floor and jax passes the whole
    cotangent to each side (exp(0)) and torch half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        def finite(v):                   # jax's _replace_inf
            return torch.nan_to_num(v, nan=float("nan"), posinf=0.0,
                                    neginf=0.0)

        a, b, out = (finite(v) for v in ctx.saved_tensors)
        return g * torch.exp(a - out), g * torch.exp(b - out)


NEG = -1e30


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """CTC loss, (B, 1), by the dense log-domain forward algorithm over the
    extended label (blank, l1, blank, ..., blank) of S = 2L + 1 states,
    log-probabilities -1e30 for the impossible: Logits (B, T, C) padded,
    Label (B, L) padded with ``blank``, LogitsLength (all T when absent)
    and LabelLength (the count of non-blank labels when absent). Past a
    row's LogitsLength its alphas stay frozen. ``norm_by_times`` is not
    read, as in the reference."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].long()
    blank = attrs.get("blank", 0)
    if logits.dim() == 2:
        logits = logits[None]
        label = label[None] if label.dim() == 1 else label
    bsz, t_len = logits.shape[0], logits.shape[1]
    n_lab = label.shape[1]
    dev = logits.device
    logits_len = (ins["LogitsLength"][0].reshape(-1).long()
                  if ins.get("LogitsLength")
                  else torch.full((bsz,), t_len, dtype=torch.long,
                                  device=dev))
    label_len = (ins["LabelLength"][0].reshape(-1).long()
                 if ins.get("LabelLength")
                 else (label != blank).sum(dim=1))
    logp = torch.log_softmax(logits, dim=-1)
    neg = scalar(NEG, logp)
    s_len = 2 * n_lab + 1
    ext = torch.full((bsz, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    pos = torch.arange(s_len, device=dev)[None, :]
    valid_ext = pos < (2 * label_len[:, None] + 1)
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :s_len]
    can_skip = (ext != ext_m2) & (pos >= 2)
    # every step's emissions at once: (B, T, S)
    emit = logp.gather(2, ext.clamp(min=0)[:, None, :].expand(
        bsz, t_len, s_len))
    alpha = torch.cat([
        emit[:, 0, :1],
        torch.where(label_len[:, None] > 0, emit[:, 0, 1:2], neg),
        neg.expand(bsz, s_len - 2)], dim=1)
    # (T, B, 1): the steps each row is still inside its LogitsLength
    live = (torch.arange(t_len, device=dev)[:, None]
            < logits_len[None, :])[..., None]
    lae = JaxLogAddExp.apply
    for t in range(1, t_len):
        a_m1 = torch.cat([neg.expand(bsz, 1), alpha[:, :-1]], dim=1)
        a_m2 = torch.cat([neg.expand(bsz, 2), alpha[:, :-2]], dim=1)
        a_m2 = torch.where(can_skip, a_m2, neg)
        new = lae(lae(alpha, a_m1), a_m2) + emit[:, t]
        new = torch.where(valid_ext, new, neg)
        alpha = torch.where(live[t], new, alpha)
    end1 = (2 * label_len - 1).clamp(min=0)[:, None]
    a1 = torch.where(label_len > 0, alpha.gather(1, end1)[:, 0], neg)
    a2 = alpha.gather(1, (2 * label_len)[:, None])[:, 0]
    return {"Loss": [(-lae(a1, a2))[:, None]]}
