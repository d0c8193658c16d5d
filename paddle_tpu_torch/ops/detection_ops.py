"""Detection op lowerings: the ROI family (roi_pool, roi_align, psroi_pool,
prroi_pool), deformable_conv, box_coder, iou_similarity, prior_box,
density_prior_box, yolo_box, box_clip, multiclass_nms, bipartite_match and
yolov3_loss (ref: paddle/fluid/operators/detection/, roi_pool_op.cc,
roi_align_op.cc). Port of the paddle_tpu/ops/detection_ops.py lowerings.

ROIs are the dense (R, 4) box tensor with a companion batch-index vector
(LoD becomes static shapes). Where the reference vmaps over images or
ROIs, these lowerings are batched tensor code over that axis; where it
runs a fixed-length ``lax.scan`` (the NMS loops, ``bipartite_match``), a
Python loop of the same length runs on device tensors, with masks for
what the scan selects, and reads nothing back to the host. Ties resolve
as the reference's: ``torch.argmax`` takes the first maximum as
``jnp.argmax`` does; sorts are stable (:func:`tensor_ops.stable_argsort`);
``top_k`` ties come out in index order. Integer outputs the reference
gives as int32 on purpose (``roi_pool``'s Argmax) stay int32;
``multiclass_nms``' Index and ``bipartite_match``'s indices are int64
(ROADMAP.md Queue 3).

The arithmetic follows the reference's order, and Python constants enter
as jax's weak scalars do (rounded to float32 once): ``prior_box``'s priors
equal the JAX package's bit for bit.
"""
import numpy as np
import torch

from .registry import register_op, single
from .tensor_ops import stable_argsort


def scalar(v, like):
    """A Python number as a 0-dim tensor of `like`'s dtype and device, made
    by a fill on the device: ``torch.tensor(v, device=...)`` copies from
    pageable host memory and waits for the stream, once for every step of
    an NMS loop."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def table(values, device, dtype=torch.float32):
    """A small constant table (variances, anchors) on `device`, copied
    from the host without waiting for the stream."""
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(
        device, non_blocking=True)


def jmax(x, v):
    """``jnp.maximum(x, v)`` for a Python scalar `v`: a tie splits the
    gradient, as jax's maximum does (``clamp``'s gives it all to x)."""
    return torch.maximum(x, scalar(v, x))


def jmin(x, v):
    return torch.minimum(x, scalar(v, x))


def jclip(x, lo, hi):
    """``jnp.clip``: maximum, then minimum (tensor or Python bounds)."""
    lo = lo if isinstance(lo, torch.Tensor) else scalar(lo, x)
    hi = hi if isinstance(hi, torch.Tensor) else scalar(hi, x)
    return torch.minimum(torch.maximum(x, lo), hi)


def roi_batch_idx(ins, n_rois, device):
    if ins.get("RoisBatchIdx"):
        return ins["RoisBatchIdx"][0].long().reshape(-1)
    return torch.zeros((n_rois,), dtype=torch.long, device=device)


def _grid_patch(x, bidx, yi, xi):
    """x[bidx[r]][:, yi[r]][:, :, xi[r]] for every ROI r: (R, C, gh, gw)
    from (R, gh) row and (R, gw) column indices."""
    out = x[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
    return out.permute(0, 3, 1, 2)


def points(x, bidx, yy, xx):
    """x[bidx[r], :, yy[r], xx[r]] for index tensors of the same shape
    (R, ...): (R, C, ...)."""
    shape = yy.shape
    b = bidx.reshape((-1,) + (1,) * (len(shape) - 1)).expand(shape)
    out = x[b, :, yy, xx]
    return out.movedim(-1, 1)


@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """Max over a dense 4x4 sample grid per bin of the ROI rounded to
    whole cells (static shapes); Argmax is zeros, int32."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    r = rois.shape[0]
    bidx = roi_batch_idx(ins, r, x.device)
    x1 = torch.round(rois[:, 0] * scale).to(torch.int32)
    y1 = torch.round(rois[:, 1] * scale).to(torch.int32)
    x2 = torch.maximum(torch.round(rois[:, 2] * scale).to(torch.int32), x1 + 1)
    y2 = torch.maximum(torch.round(rois[:, 3] * scale).to(torch.int32), y1 + 1)
    gh, gw = ph * 4, pw * 4
    ar_h = torch.arange(gh, device=x.device, dtype=torch.float32) + 0.5
    ar_w = torch.arange(gw, device=x.device, dtype=torch.float32) + 0.5
    ys = y1[:, None] + ar_h[None] * (y2 - y1)[:, None] / gh
    xs = x1[:, None] + ar_w[None] * (x2 - x1)[:, None] / gw
    yi = ys.to(torch.int32).clamp(0, h - 1).long()
    xi = xs.to(torch.int32).clamp(0, w - 1).long()
    patch = _grid_patch(x, bidx, yi, xi).reshape(r, c, ph, 4, pw, 4)
    out = torch.amax(patch, dim=(3, 5))
    return {"Out": [out],
            "Argmax": [torch.zeros(out.shape, dtype=torch.int32,
                                   device=x.device)]}


def _bilinear(x, bidx, y, x_, h, w):
    """The reference's roi_align sample at (y, x_), (R, ph, pw) each:
    (R, C, ph, pw), indices clipped into the map."""
    y0 = torch.floor(y).to(torch.int32)
    x0 = torch.floor(x_).to(torch.int32)
    y1, x1 = y0 + 1, x0 + 1
    wy = y - y0
    wx = x_ - x0
    y0c = y0.clamp(0, h - 1).long()
    y1c = y1.clamp(0, h - 1).long()
    x0c = x0.clamp(0, w - 1).long()
    x1c = x1.clamp(0, w - 1).long()
    wy, wx = wy[:, None], wx[:, None]
    return (points(x, bidx, y0c, x0c) * (1 - wy) * (1 - wx)
            + points(x, bidx, y0c, x1c) * (1 - wy) * wx
            + points(x, bidx, y1c, x0c) * wy * (1 - wx)
            + points(x, bidx, y1c, x1c) * wy * wx)


@register_op("roi_align")
def _roi_align(ctx, ins, attrs):
    """Average of ratio x ratio bilinear samples a bin (``sampling_ratio``
    <= 0 takes 2), the ROI at least one cell a side."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    ratio = attrs.get("sampling_ratio", -1)
    if ratio <= 0:
        ratio = 2
    n, c, h, w = x.shape
    r = rois.shape[0]
    bidx = roi_batch_idx(ins, r, x.device)
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    x2 = rois[:, 2] * scale
    y2 = rois[:, 3] * scale
    bin_h = (jmax(y2 - y1, 1.0) / ph)[:, None, None]
    bin_w = (jmax(x2 - x1, 1.0) / pw)[:, None, None]
    ar_h = torch.arange(ph, device=x.device)[:, None]
    ar_w = torch.arange(pw, device=x.device)[None, :]
    acc = torch.zeros((r, c, ph, pw), dtype=x.dtype, device=x.device)
    for iy in range(ratio):
        for ix in range(ratio):
            yy = y1[:, None, None] + (ar_h + (iy + 0.5) / ratio) * bin_h
            xx = x1[:, None, None] + (ar_w + (ix + 0.5) / ratio) * bin_w
            yy, xx = torch.broadcast_tensors(yy, xx)
            acc = acc + _bilinear(x, bidx, yy, xx, h, w)
    return single(acc / (ratio * ratio))


@register_op("psroi_pool")
def _psroi_pool(ctx, ins, attrs):
    """Position-sensitive ROI pooling (R-FCN): bin (i, j) of output
    channel c averages input channel c·ph·pw + i·pw + j over a 4x4 grid."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    bidx = roi_batch_idx(ins, rois.shape[0], x.device)
    out_c = attrs["output_channels"]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    n, c_in, h, w = x.shape
    r = rois.shape[0]
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    x2 = rois[:, 2] * scale
    y2 = rois[:, 3] * scale
    rh = jmax(y2 - y1, 0.1)
    rw = jmax(x2 - x1, 0.1)
    gh, gw = ph * 4, pw * 4
    ar_h = torch.arange(gh, device=x.device, dtype=x.dtype) + 0.5
    ar_w = torch.arange(gw, device=x.device, dtype=x.dtype) + 0.5
    ys = y1[:, None] + ar_h[None] * rh[:, None] / gh
    xs = x1[:, None] + ar_w[None] * rw[:, None] / gw
    yi = ys.to(torch.int32).clamp(0, h - 1).long()
    xi = xs.to(torch.int32).clamp(0, w - 1).long()
    patch = _grid_patch(x, bidx, yi, xi).reshape(r, c_in, ph, 4, pw, 4)
    patch = patch.mean(dim=(3, 5))                      # (R, C_in, ph, pw)
    ci = torch.arange(out_c, device=x.device)[:, None, None]
    ii = torch.arange(ph, device=x.device)[None, :, None]
    jj = torch.arange(pw, device=x.device)[None, None, :]
    chan = ci * ph * pw + ii * pw + jj
    return {"Out": [patch[:, chan, ii, jj]]}


@register_op("prroi_pool")
def _prroi_pool(ctx, ins, attrs):
    """Precise ROI pooling as the reference approximates it: the mean of a
    dense 8x8 bilinear sample grid a bin (differentiable in the ROIs)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    bidx = roi_batch_idx(ins, rois.shape[0], x.device)
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    r = rois.shape[0]
    ss = 8
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    x2 = rois[:, 2] * scale
    y2 = rois[:, 3] * scale
    rh = jmax(y2 - y1, 1e-6)
    rw = jmax(x2 - x1, 1e-6)
    gh, gw = ph * ss, pw * ss
    ar_h = torch.arange(gh, device=x.device, dtype=x.dtype) + 0.5
    ar_w = torch.arange(gw, device=x.device, dtype=x.dtype) + 0.5
    ys = y1[:, None] + ar_h[None] * rh[:, None] / gh - 0.5
    xs = x1[:, None] + ar_w[None] * rw[:, None] / gw - 0.5
    y0 = torch.floor(ys).to(torch.int32)
    x0 = torch.floor(xs).to(torch.int32)
    wy = (ys - y0)[:, None, :, None]
    wx = (xs - x0)[:, None, None, :]

    def at(yy, xx):
        return _grid_patch(x, bidx, yy.clamp(0, h - 1).long(),
                           xx.clamp(0, w - 1).long())

    val = (at(y0, x0) * (1 - wy) * (1 - wx)
           + at(y0, x0 + 1) * (1 - wy) * wx
           + at(y0 + 1, x0) * wy * (1 - wx)
           + at(y0 + 1, x0 + 1) * wy * wx)              # (R, C, gh, gw)
    return {"Out": [val.reshape(r, c, ph, ss, pw, ss).mean(dim=(3, 5))]}


def _pair2(v, k=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * k


@register_op("deformable_conv")
def _deformable_conv(ctx, ins, attrs):
    """Deformable convolution v1, or v2 with a Mask: each output position
    and kernel tap samples the input bilinearly at p + p_k + Δp_k (zero
    outside the map), optionally modulated; then a grouped contraction
    with the filter (``torch.einsum``)."""
    x = ins["Input"][0]        # (N, C, H, W)
    offset = ins["Offset"][0]  # (N, 2·dg·kh·kw, Ho, Wo), (dy, dx) pairs
    mask = ins["Mask"][0] if ins.get("Mask") else None
    wt = ins["Filter"][0]      # (Co, C/g, kh, kw)
    strides = _pair2(attrs.get("strides", [1, 1]))
    pads = _pair2(attrs.get("paddings", [1, 1]))
    dils = _pair2(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1) or 1
    dg = attrs.get("deformable_groups", 1) or 1
    n, c, h, wd = x.shape
    co, cg, kh, kw = wt.shape
    ho = (h + 2 * pads[0] - dils[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (wd + 2 * pads[1] - dils[1] * (kw - 1) - 1) // strides[1] + 1
    dev = x.device
    oy = torch.arange(ho, device=dev) * strides[0] - pads[0]
    ox = torch.arange(wo, device=dev) * strides[1] - pads[1]
    ky = torch.arange(kh, device=dev) * dils[0]
    kx = torch.arange(kw, device=dev) * dils[1]
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    off = offset.reshape(n, dg, kh, kw, 2, ho, wo)
    dy = off[:, :, :, :, 0].permute(0, 1, 4, 5, 2, 3)  # (N, dg, ho, wo, kh, kw)
    dx = off[:, :, :, :, 1].permute(0, 1, 4, 5, 2, 3)
    py = base_y + dy
    px = base_x + dx
    y0 = torch.floor(py).to(torch.int32)
    x0 = torch.floor(px).to(torch.int32)
    wy = py - y0
    wx = px - x0
    cpd = c // dg
    xg = x.reshape(n, dg, cpd, h, wd)
    ni = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1, 1)
    gi = torch.arange(dg, device=dev).reshape(1, dg, 1, 1, 1, 1)

    def at(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < wd)
        yy = yy.clamp(0, h - 1).long()
        xx = xx.clamp(0, wd - 1).long()
        v = xg[ni, gi, :, yy, xx]                # (N, dg, ho, wo, kh, kw, cpd)
        v = v.movedim(-1, 2)                     # (N, dg, cpd, ho, wo, kh, kw)
        return v * inb[:, :, None].to(x.dtype)

    val = (at(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None]
           + at(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None]
           + at(y0 + 1, x0) * (wy * (1 - wx))[:, :, None]
           + at(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])
    if mask is not None:
        m = mask.reshape(n, dg, kh, kw, ho, wo).permute(0, 1, 4, 5, 2, 3)
        val = val * m[:, :, None]
    vg = val.reshape(n, groups, c // groups, ho, wo, kh, kw)
    wg = wt.reshape(groups, co // groups, cg, kh, kw)
    out = torch.einsum("ngchwkl,gockl->ngohw", vg, wg)
    return {"Output": [out.reshape(n, co, ho, wo)]}


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    """Encode TargetBox (N, 4) against the priors (M, 4) into (N, M, 4)
    offsets (log(|t/p|) sizes), or decode (N, M, 4) / (M, 4) offsets
    (exp sizes); PriorBoxVar (M, 4) divides or scales them."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else None
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    off = 0.0 if attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        dh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        if pvar is not None:
            out = out / pvar[None, :, :]
        return {"OutputBox": [out]}
    t = target
    if pvar is not None:
        t = t * pvar[None, :, :]
    dcx = t[..., 0] * pw + pcx
    dcy = t[..., 1] * ph + pcy
    dw = torch.exp(t[..., 2]) * pw
    dh = torch.exp(t[..., 3]) * ph
    out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                       dcx + dw * 0.5 - off, dcy + dh * 0.5 - off], dim=-1)
    return {"OutputBox": [out]}


def iou_matrix(a, b):
    """IoU of boxes a (..., P, 4) against b (..., Q, 4): (..., P, Q), the
    union floored at 1e-10."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = jmax(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / jmax(area_a[..., :, None] + area_b[..., None, :] - inter,
                        1e-10)


@register_op("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    return single(iou_matrix(ins["X"][0], ins["Y"][0]))


def _prior_stack(boxes, clip, variances):
    out = torch.stack(boxes, dim=2)                  # (H, W, priors, 4)
    if clip:
        out = jclip(out, 0.0, 1.0)
    var = table(variances, out.device).expand(out.shape)
    return out, var


@register_op("prior_box")
def _prior_box(ctx, ins, attrs):
    """SSD prior boxes (H, W, priors, 4) and their variances. The sizes
    are numpy float64 values (sqrt of the ratios), applied to float32
    grids as jax applies them: each rounded to float32 once, the order of
    the reference's operations kept, so the priors equal its bit for
    bit."""
    feat, image = ins["Input"][0], ins["Image"][0]
    max_sizes = attrs.get("max_sizes", [])
    flip = attrs.get("flip", True)
    offset = attrs.get("offset", 0.5)
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = attrs.get("step_w", 0.0) or iw / w
    sh = attrs.get("step_h", 0.0) or ih / h
    ars = []
    for r in attrs.get("aspect_ratios", [1.0]):
        ars.append(r)
        if flip and abs(r - 1.0) > 1e-6:
            ars.append(1.0 / r)
    dev = feat.device
    cx = (torch.arange(w, device=dev) + offset) * sw
    cy = (torch.arange(h, device=dev) + offset) * sh
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    boxes = []
    for ms_i, ms in enumerate(attrs["min_sizes"]):
        sizes = [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars]
        if ms_i < len(max_sizes):
            sizes.append((np.sqrt(ms * max_sizes[ms_i]),) * 2)
        for bw, bh in sizes:
            half_w = scalar(float(bw / 2), cxg)
            half_h = scalar(float(bh / 2), cyg)
            boxes.append(torch.stack([(cxg - half_w) / iw,
                                      (cyg - half_h) / ih,
                                      (cxg + half_w) / iw,
                                      (cyg + half_h) / ih], dim=-1))
    out, var = _prior_stack(boxes, attrs.get("clip", False),
                            attrs.get("variances", [0.1, 0.1, 0.2, 0.2]))
    return {"Boxes": [out], "Variances": [var]}


@register_op("density_prior_box")
def _density_prior_box(ctx, ins, attrs):
    """Density priors: for each (density d, fixed size s) and ratio, the
    boxes on a d x d sub-grid inside every cell, shifted by step/d."""
    feat, image = ins["Input"][0], ins["Image"][0]
    densities = attrs.get("densities", [1])
    fixed_sizes = attrs.get("fixed_sizes", [1.0])
    offset = attrs.get("offset", 0.5)
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = attrs.get("step_w", 0.0) or iw / w
    sh = attrs.get("step_h", 0.0) or ih / h
    dev = feat.device
    cx0 = torch.arange(w, device=dev) * sw + offset * sw
    cy0 = torch.arange(h, device=dev) * sh + offset * sh
    cyg, cxg = torch.meshgrid(cy0, cx0, indexing="ij")
    if len(densities) != len(fixed_sizes):
        raise ValueError(
            "density_prior_box: densities (%d) and fixed_sizes (%d) must "
            "align one-to-one" % (len(densities), len(fixed_sizes)))
    boxes = []
    for d, s in zip(densities, fixed_sizes):
        shift_w, shift_h = sw / d, sh / d
        for r in attrs.get("fixed_ratios", [1.0]):
            half_w = scalar(float(s * np.sqrt(r) / 2), cxg)
            half_h = scalar(float(s / np.sqrt(r) / 2), cyg)
            for dy in range(d):
                for dx in range(d):
                    cx = cxg - sw / 2 + shift_w / 2 + dx * shift_w
                    cy = cyg - sh / 2 + shift_h / 2 + dy * shift_h
                    boxes.append(torch.stack(
                        [(cx - half_w) / iw, (cy - half_h) / ih,
                         (cx + half_w) / iw, (cy + half_h) / ih], dim=-1))
    out, var = _prior_stack(boxes, attrs.get("clip", False),
                            attrs.get("variances", [0.1, 0.1, 0.2, 0.2]))
    if attrs.get("flatten_to_2d", False):
        out, var = out.reshape(-1, 4), var.reshape(-1, 4)
    return {"Boxes": [out], "Variances": [var]}


@register_op("yolo_box")
def _yolo_box(ctx, ins, attrs):
    """YOLOv3 box decoding: (N, A·H·W, 4) boxes in image pixels and
    (N, A·H·W, classes) scores, both zero below ``conf_thresh``."""
    x = ins["X"][0]
    img_size = ins["ImgSize"][0]
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    conf_thresh = attrs.get("conf_thresh", 0.01)
    downsample = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    dev = x.device
    grid_x = torch.arange(w, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, device=dev)[None, None, :, None]
    aw = table(anchors[0::2], dev)[None, :, None, None]
    ah = table(anchors[1::2], dev)[None, :, None, None]
    input_h, input_w = downsample * h, downsample * w
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / h
    bw = torch.exp(x[:, :, 2]) * aw / input_w
    bh = torch.exp(x[:, :, 3]) * ah / input_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    mask = (conf > conf_thresh).to(x.dtype)
    imgh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imgw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    boxes = torch.stack([(bx - bw / 2) * imgw, (by - bh / 2) * imgh,
                         (bx + bw / 2) * imgw, (by + bh / 2) * imgh], dim=-1)
    boxes = (boxes * mask[..., None]).reshape(n, na * h * w, 4)
    scores = (probs * mask[:, :, None]).permute(0, 1, 3, 4, 2).reshape(
        n, na * h * w, class_num)
    return {"Boxes": [boxes], "Scores": [scores]}


@register_op("box_clip")
def _box_clip(ctx, ins, attrs):
    """Boxes clipped to [0, round(im / scale) - 1] of their image, in the
    original image's coordinates (ImInfo rows: resized h, w, scale)."""
    boxes = ins["Input"][0]
    im_info = ins["ImInfo"][0]
    if im_info.dim() == 1:
        im_info = im_info[None]
    if im_info.shape[1] > 2:
        scale = jmax(im_info[:, 2], 1e-6)
    else:
        scale = 1.0
    h = torch.round(im_info[:, 0] / scale) - 1
    w = torch.round(im_info[:, 1] / scale) - 1
    squeeze = boxes.dim() == 2
    if squeeze:
        boxes = boxes[None]
    zero = scalar(0.0, boxes)
    out = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w[:, None]),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h[:, None]),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w[:, None]),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h[:, None]),
    ], dim=-1)
    return {"Output": [out[0] if squeeze else out]}


def row(t, idx):
    """t[idx] for a one-element index tensor, read on the device (an
    index tensor in ``t[i]`` may be read back to the host)."""
    return t.index_select(0, idx.reshape(1))[0]


def take(values, idx):
    """values[n, idx[n]] for (N, K, ...) values and (N,) indices."""
    return values[torch.arange(values.shape[0], device=values.device), idx]


def greedy_nms(scores, boxes, cls, steps, thresh, fill, iou=None):
    """The reference's static greedy NMS, batched over images: `steps`
    times, take each image's first highest candidate of `scores` (N, K),
    and mark it and every candidate of its class overlapping it by more
    than `thresh` with `fill`. Returns the picks' (index (N, S), score
    (N, S), box (N, S, 4), class (N, S)). A fixed-length loop on device
    tensors, nothing read back."""
    iou = iou or iou_matrix
    cur = scores
    fill = scalar(fill, scores)
    ar = torch.arange(scores.shape[1], device=scores.device)
    picks = []
    for _ in range(steps):
        best = torch.argmax(cur, dim=1)
        best_score = take(cur, best)
        best_box = take(boxes, best)
        best_cls = cls[best] if cls.dim() == 1 else take(cls, best)
        ious = iou(best_box[:, None], boxes)[:, 0]
        same = cls[None] == best_cls[:, None] if cls.dim() == 1 else \
            cls == best_cls[:, None]
        suppress = ((ious > thresh) & same) | (ar[None] == best[:, None])
        cur = torch.where(suppress, fill, cur)
        picks.append((best, best_score, best_box, best_cls))
    return tuple(torch.stack(p, dim=1) for p in zip(*picks))


def _nms_adaptive(flat_scores, flat_box, flat_cls, n_cls, keep_top_k,
                  nms_thresh, nms_eta):
    """Adaptive NMS (nms_eta < 1), the reference's NMSFast order, batched
    over images: the top keep_top_k candidates of each class, in score
    order, each tested at its turn against the kept set with its class's
    threshold, which decays once per kept box while above 0.5. A loop of
    keep_top_k·C steps. (N, keep_top_k, 6) rows."""
    n, total = flat_scores.shape
    dev, dtype = flat_scores.device, flat_scores.dtype
    cap = min(total, max(int(keep_top_k), 1) * max(int(n_cls), 1))
    sorted_idx = stable_argsort(flat_scores, dim=1, descending=True)
    cls_sorted = flat_cls[sorted_idx]                        # (N, total)
    onehot = (cls_sorted[..., None] == torch.arange(
        n_cls, device=dev)).to(torch.int32)
    rank_in_class = torch.cumsum(onehot, dim=1).gather(
        2, cls_sorted[..., None])[..., 0] - 1
    keyed = torch.where(rank_in_class < keep_top_k,
                        flat_scores.gather(1, sorted_idx),
                        scalar(float("-inf"), flat_scores))
    sel = stable_argsort(keyed, dim=1, descending=True)[:, :cap]
    order = sorted_idx.gather(1, sel)
    k = keep_top_k
    slots = torch.arange(k, device=dev)
    classes = torch.arange(n_cls, device=dev)
    kept_box = torch.zeros((n, k, 4), dtype=dtype, device=dev)
    kept_cls = torch.full((n, k), -1, dtype=torch.long, device=dev)
    kept_score = torch.zeros((n, k), dtype=dtype, device=dev)
    n_kept = torch.zeros((n,), dtype=torch.long, device=dev)
    thresh = torch.full((n, n_cls), nms_thresh, dtype=dtype, device=dev)
    for s in range(cap):
        idx = order[:, s]
        sc = take(flat_scores, idx)
        box = take(flat_box, idx)
        c = flat_cls[idx]
        ious = iou_matrix(box[:, None], kept_box)[:, 0]        # (N, K)
        overlapped = ((ious > take(thresh, c)[:, None])
                      & (kept_cls == c[:, None])
                      & (slots[None] < n_kept[:, None])).any(dim=1)
        keep = (sc > 0) & ~overlapped & (n_kept < k)
        write = keep[:, None] & (slots[None] == n_kept[:, None])
        kept_box = torch.where(write[..., None], box[:, None], kept_box)
        kept_cls = torch.where(write, c[:, None], kept_cls)
        kept_score = torch.where(write, sc[:, None], kept_score)
        thresh = torch.where(
            keep[:, None] & (classes[None] == c[:, None]) & (thresh > 0.5),
            thresh * nms_eta, thresh)
        n_kept = n_kept + keep.long()
    label = torch.where(kept_score > 0, kept_cls, -1).to(dtype)
    return torch.cat([label[..., None], kept_score[..., None], kept_box],
                     dim=2)


def _select_scores(sc, nms_top_k):
    """Scores below each class's ``nms_top_k``-th largest set to -1 (the
    kth value kept with all its ties, as ``lax.top_k``'s kth)."""
    m = sc.shape[-1]
    if nms_top_k is not None and 0 < nms_top_k < m:
        kth = torch.topk(sc, nms_top_k, dim=-1).values[..., -1:]
        sc = torch.where(sc >= kth, sc, scalar(-1.0, sc))
    return sc


@register_op("multiclass_nms")
def _multiclass_nms(ctx, ins, attrs):
    """Static-shape greedy NMS: exactly (N, keep_top_k, 6) rows [label,
    score, x1, y1, x2, y2] padded with label -1, and Index (N, keep_top_k,
    1), the kept box's row in BBoxes (-1 on padding; int64)."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]   # (N,M,4), (N,C,M)
    score_thresh = attrs["score_threshold"]
    nms_thresh = attrs.get("nms_threshold", 0.3)
    nms_eta = attrs.get("nms_eta", 1.0)
    keep_top_k = attrs["keep_top_k"]
    background = attrs.get("background_label", 0)
    n, c, m = scores.shape
    sc = _select_scores(scores, attrs.get("nms_top_k", -1))
    flat_cls = torch.arange(c, device=sc.device).repeat_interleave(m)
    flat_scores = sc.reshape(n, c * m)
    flat_box = bboxes.repeat(1, c, 1)
    valid = (flat_scores > score_thresh) & (flat_cls != background)[None]
    flat_scores = torch.where(valid, flat_scores, scalar(-1.0, flat_scores))
    if nms_eta < 1.0:
        rows = _nms_adaptive(flat_scores, flat_box, flat_cls, c,
                             keep_top_k, nms_thresh, nms_eta)
        index = torch.full((n, keep_top_k), -1, dtype=torch.long,
                           device=sc.device)
        return {"Out": [rows], "Index": [index[..., None]]}
    best, score, box, cls = greedy_nms(flat_scores, flat_box, flat_cls,
                                       keep_top_k, nms_thresh, -1.0)
    label = torch.where(score > 0, cls, -1).to(bboxes.dtype)
    rows = torch.cat([label[..., None], score[..., None], box], dim=2)
    index = torch.where(score > 0, best % m, -1)
    return {"Out": [rows], "Index": [index[..., None]]}


@register_op("bipartite_match")
def _bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching of DistMat (R, C): min(R, C) times take
    the global maximum (the first in row-major order), match its column
    to its row, and strike both out. ColToRowMatchIndices (1, C) int64,
    -1 where unmatched; ColToRowMatchDist (1, C)."""
    dist = ins["DistMat"][0]
    r, c = dist.shape
    dev = dist.device
    d = dist
    col_to_row = torch.full((c,), -1, dtype=torch.long, device=dev)
    col_dist = torch.zeros((c,), dtype=dist.dtype, device=dev)
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    struck = scalar(-1e30, dist)
    for _ in range(min(r, c)):
        idx = torch.argmax(d)
        ri, ci = idx // c, idx % c
        val = row(d.reshape(-1), idx)
        hit = (val > -1e20) & (cols == ci)
        col_to_row = torch.where(hit, ri, col_to_row)
        col_dist = torch.where(hit, val, col_dist)
        d = torch.where(rows[:, None] == ri, struck, d)
        d = torch.where(cols[None, :] == ci, struck, d)
    return {"ColToRowMatchIndices": [col_to_row[None, :]],
            "ColToRowMatchDist": [col_dist[None, :]]}


def _bce(logit, target):
    return (jmax(logit, 0.0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


@register_op("yolov3_loss")
def _yolov3_loss(ctx, ins, attrs):
    """YOLOv3 training loss per image: coordinate BCE/MSE and class BCE on
    the anchor cell each gt is assigned to (its centre cell, its best
    masked anchor by wh IoU), objectness BCE, with negatives whose
    decoded box overlaps any gt above ``ignore_thresh`` ignored. Padding
    gt rows scatter into a dump column that is sliced away."""
    x = ins["X"][0]
    gt_box = ins["GTBox"][0]                          # (N, G, 4) cx cy w h
    gt_label = ins["GTLabel"][0].long()
    anchors = np.asarray(attrs["anchors"], np.float32)
    anchor_mask = list(attrs["anchor_mask"])
    class_num = attrs["class_num"]
    ignore_thresh = attrs.get("ignore_thresh", 0.7)
    downsample = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchor_mask)
    dev = x.device
    input_h, input_w = downsample * h, downsample * w
    xi = x.reshape(n, na, 5 + class_num, h, w).movedim(2, 1)  # (N,5+C,A,H,W)
    masked = table(anchors.reshape(-1, 2)[anchor_mask], dev)
    valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)       # (N, G)
    gi = (gt_box[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gt_box[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
    gi = torch.where(valid, gi, w)
    gw = gt_box[..., 2] * input_w
    gh = gt_box[..., 3] * input_h
    aw, ah = masked[:, 0], masked[:, 1]
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None], ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best_a = torch.argmax(inter / jmax(union, 1e-10), dim=-1)  # (N, G)
    ni = torch.arange(n, device=dev)[:, None].expand_as(best_a)

    def scat(vals, init=0.0, dtype=torch.float32):
        t = torch.full((n, na, h, w + 1), init, dtype=dtype, device=dev)
        t[ni, best_a, gj, gi] = vals.to(dtype)
        return t[..., :w]

    obj_target = scat(valid.to(torch.float32))
    txt = scat(gt_box[..., 0] * w - torch.clamp(gi, max=w - 1))
    tyt = scat(gt_box[..., 1] * h - gj)
    mw, mh = masked[best_a, 0], masked[best_a, 1]
    twt = scat(torch.log(jmax(gw / jmax(mw, 1e-6), 1e-6)))
    tht = scat(torch.log(jmax(gh / jmax(mh, 1e-6), 1e-6)))
    cls_t = scat(gt_label, init=0, dtype=torch.long)
    pos = obj_target
    txi, tyi, twi, thi = xi[:, 0], xi[:, 1], xi[:, 2], xi[:, 3]
    obj_logit, cls_logit = xi[:, 4], xi[:, 5:]
    coord = pos * (_bce(txi, txt) + _bce(tyi, tyt)
                   + (twi - twt) ** 2 + (thi - tht) ** 2)
    grid_x = torch.arange(w, device=dev)[None, None, :]
    grid_y = torch.arange(h, device=dev)[None, :, None]
    px = (torch.sigmoid(txi) + grid_x) / w
    py = (torch.sigmoid(tyi) + grid_y) / h
    pw = torch.exp(jclip(twi, -10, 10)) * (aw[:, None, None] / input_w)
    ph = torch.exp(jclip(thi, -10, 10)) * (ah[:, None, None] / input_h)
    # IoU of every prediction (N, A, H, W) against every gt (N, G)
    gb = gt_box[:, :, None, None, None, :]
    pxe, pye, pwe, phe = (v[:, None] for v in (px, py, pw, ph))
    ix = torch.minimum(pxe + pwe / 2, gb[..., 0] + gb[..., 2] / 2) \
        - torch.maximum(pxe - pwe / 2, gb[..., 0] - gb[..., 2] / 2)
    iy = torch.minimum(pye + phe / 2, gb[..., 1] + gb[..., 3] / 2) \
        - torch.maximum(pye - phe / 2, gb[..., 1] - gb[..., 3] / 2)
    inter_ = jmax(ix, 0.0) * jmax(iy, 0.0)
    union_ = pwe * phe + gb[..., 2] * gb[..., 3] - inter_
    ious = inter_ / jmax(union_, 1e-10)                      # (N,G,A,H,W)
    ious = torch.where(valid[:, :, None, None, None], ious,
                       scalar(0.0, ious))
    best_iou = torch.amax(ious, dim=1)
    noobj = (pos == 0) & (best_iou <= ignore_thresh)
    obj_l = pos * _bce(obj_logit, 1.0) + noobj * _bce(obj_logit, 0.0)
    cls_oh = (cls_t[:, None] == torch.arange(class_num, device=dev)[
        None, :, None, None, None]).to(torch.float32)
    cls_l = pos[:, None] * _bce(cls_logit, cls_oh)
    loss = coord.sum(dim=(1, 2, 3)) + obj_l.sum(dim=(1, 2, 3)) \
        + cls_l.sum(dim=(1, 2, 3, 4))
    return {"Loss": [loss]}
