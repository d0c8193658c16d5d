"""RCNN and RetinaNet detection op lowerings: anchor_generator,
sigmoid_focal_loss, polygon_box_transform, box_decoder_and_assign,
target_assign, rpn_target_assign, retinanet_target_assign,
generate_proposals, retinanet_detection_output, locality_aware_nms,
generate_proposal_labels, generate_mask_labels, roi_perspective_transform
and detection_map (ref: paddle/fluid/operators/detection/). Port of the
paddle_tpu/ops/rcnn_ops.py lowerings.

The reference's dense forms are kept: LoD inputs and outputs are padded
tensors with validity masks, target assigns return full per-anchor
targets and weights, sampling is deterministic in index order (the
reference's use_random=False rule). Its vmaps over images and ROIs are
batched tensor code here; its fixed-length scans (the NMS of
``generate_proposals``, ``retinanet_detection_output`` and
``locality_aware_nms``, the merge pass, ``detection_map``'s matching)
are Python loops of the same length on device tensors, masks where the
scan selects, nothing read back to the host. Integer outputs the
reference declares int32 (``ScoreTarget``, ``LabelsInt32``, the mask
labels) stay int32.
"""
import numpy as np
import torch

from .detection_ops import (greedy_nms, iou_matrix, jclip, jmax, jmin,
                            points, roi_batch_idx, row, scalar, table, take)
from .registry import register_op, single
from .tensor_ops import stable_argsort


@register_op("anchor_generator")
def _anchor_generator(ctx, ins, attrs):
    """Faster-RCNN anchors (H, W, A, 4): per cell, aspect ratios outer,
    sizes inner, the base width and height rounded from the stride area
    before scaling."""
    feat = ins["Input"][0]
    stride = attrs["stride"]
    offset = attrs.get("offset", 0.5)
    h, w = feat.shape[2], feat.shape[3]
    sw, sh = float(stride[0]), float(stride[1])
    whs = []
    for ar in attrs["aspect_ratios"]:
        base_w = round(np.sqrt(sw * sh / ar))
        base_h = round(base_w * ar)
        for s in attrs["anchor_sizes"]:
            whs.append((s / sw * base_w, s / sh * base_h))
    dev = feat.device
    aw = table([p[0] for p in whs], dev)
    ah = table([p[1] for p in whs], dev)
    x_ctr = torch.arange(w, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1)
    y_ctr = torch.arange(h, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1)
    yg, xg = torch.meshgrid(y_ctr, x_ctr, indexing="ij")
    xg, yg = xg[..., None], yg[..., None]
    anchors = torch.stack([xg - 0.5 * (aw - 1), yg - 0.5 * (ah - 1),
                           xg + 0.5 * (aw - 1), yg + 0.5 * (ah - 1)], dim=-1)
    var = table(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                dev).expand(anchors.shape)
    return {"Anchors": [anchors], "Variances": [var]}


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ctx, ins, attrs):
    """Elementwise focal loss (R, C): labels are 1-indexed classes (0
    background gives only negative terms, -1 is ignored), normalised by
    max(FgNum, 1); log p and log(1 - p) as softplus."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    fg_num = ins["FgNum"][0].reshape(-1)[0].to(x.dtype)
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    d = torch.arange(x.shape[1], device=x.device)[None, :]
    g = label[:, None]
    c_pos = (g == d + 1).to(x.dtype)
    c_neg = ((g != -1) & (g != d + 1)).to(x.dtype)
    fg = jmax(fg_num, 1.0)
    p = torch.sigmoid(x)
    log_p = -torch.nn.functional.softplus(-x)
    log_1mp = -torch.nn.functional.softplus(x)
    term_pos = torch.pow(1.0 - p, gamma) * log_p
    term_neg = torch.pow(p, gamma) * log_1mp
    return single(-c_pos * term_pos * (alpha / fg)
                  - c_neg * term_neg * ((1.0 - alpha) / fg))


@register_op("polygon_box_transform")
def _polygon_box_transform(ctx, ins, attrs):
    """EAST quad offsets to absolute coordinates on a 4x grid: even
    channels 4·w_idx - v, odd channels 4·h_idx - v."""
    x = ins["Input"][0]
    n, g, h, w = x.shape
    wi = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    hi = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(g, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(even, 4.0 * wi - x, 4.0 * hi - x)]}


@register_op("box_decoder_and_assign")
def _box_decoder_and_assign(ctx, ins, attrs):
    """Per-class decode (+1 width convention, dw/dh clipped at
    ``box_clip``) and the box of each row's best foreground class
    (background keeps the prior)."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0]
    target = ins["TargetBox"][0]
    score = ins["BoxScore"][0]
    clip = attrs.get("box_clip", 4.135)
    r, cnum = prior.shape[0], score.shape[1]
    t = target.reshape(r, cnum, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    dw = jmin(pvar[2] * t[..., 2], clip)
    dh = jmin(pvar[3] * t[..., 3], clip)
    cx = pvar[0] * t[..., 0] * pw[:, None] + pcx[:, None]
    cy = pvar[1] * t[..., 1] * ph[:, None] + pcy[:, None]
    bw = torch.exp(dw) * pw[:, None]
    bh = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - 1,
                           cy + bh / 2 - 1], dim=-1)       # (R, C, 4)
    fg_score = score
    if cnum > 0:
        fg_score = score.clone()
        fg_score[:, 0] = float("-inf")
    best = torch.argmax(fg_score, dim=1)
    assigned = take(decoded, best)
    assigned = torch.where((best > 0)[:, None], assigned, prior)
    return {"DecodeBox": [decoded.reshape(r, cnum * 4)],
            "OutputAssignBox": [assigned]}


@register_op("target_assign")
def _target_assign(ctx, ins, attrs):
    """out[i, j] = X[i, match[i, j]] where matched, else mismatch_value
    with weight 0; a NegIndices entry >= 0 sets the weight to 1."""
    x = ins["X"][0]                                   # (N, G, K)
    match = ins["MatchIndices"][0].long()             # (N, P)
    mismatch = attrs.get("mismatch_value", 0.0)
    idx = match.clamp(min=0)
    out = x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, out, scalar(mismatch, out))
    weight = matched.to(torch.float32)
    if ins.get("NegIndices"):
        neg = ins["NegIndices"][0]
        weight = torch.maximum(weight, (neg >= 0)[:, :, None].to(weight.dtype))
    return {"Out": [out], "OutWeight": [weight]}


def _encode_boxes(anchors, gts, var=None):
    """Centre-size encoding of gts (..., 4) against anchors (..., 4), the
    +1 pixel convention."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    gw = jmax(gts[..., 2] - gts[..., 0] + 1.0, 1.0)
    gh = jmax(gts[..., 3] - gts[..., 1] + 1.0, 1.0)
    gcx = gts[..., 0] + gw / 2
    gcy = gts[..., 1] + gh / 2
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], dim=-1)
    if var is not None:
        t = t / var
    return t


def iou_xyxy(a, b):
    """IoU with the +1 pixel convention of the RCNN family: a (..., P, 4)
    against b (..., Q, 4)."""
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = jmax(rb - lt + 1, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / jmax(area_a[..., :, None] + area_b[..., None, :] - inter,
                        1e-10)


def _assign(anchors, gt, crowd, im_info, pos_ov, neg_ov, straddle, var):
    """The fg/bg analysis of rpn and retinanet target assign over images:
    anchors (M, 4), gt (N, G, 4). Returns (fg, bg, argmax gt, encoded
    targets), each per anchor (N, M, ...)."""
    n, m = gt.shape[0], anchors.shape[0]
    valid_gt = ((gt[..., 2] - gt[..., 0]) > 0) & ((gt[..., 3] - gt[..., 1]) > 0)
    valid_gt = valid_gt & ~(crowd > 0)
    iou = iou_xyxy(anchors.expand(n, m, 4), gt)              # (N, M, G)
    iou = torch.where(valid_gt[:, None, :], iou, scalar(-1.0, iou))
    a2g_max = iou.amax(dim=2)
    a2g_arg = torch.argmax(iou, dim=2)
    if straddle >= 0:
        imh, imw = im_info[:, 0:1], im_info[:, 1:2]
        inside = ((anchors[None, :, 0] >= -straddle)
                  & (anchors[None, :, 1] >= -straddle)
                  & (anchors[None, :, 2] < imw + straddle)
                  & (anchors[None, :, 3] < imh + straddle))
    else:
        inside = torch.ones((n, m), dtype=torch.bool, device=gt.device)
    g2a_max = torch.where(inside[:, :, None], iou,
                          scalar(-1.0, iou)).amax(dim=1)        # (N, G)
    is_best = ((iou >= jmax(g2a_max, 1e-10)[:, None, :])
               & valid_gt[:, None, :]).any(dim=2)
    fg = inside & ((a2g_max >= pos_ov) | is_best) & (a2g_max > 0)
    bg = inside & ~fg & (a2g_max < neg_ov)
    matched_gt = gt.gather(1, a2g_arg[..., None].expand(n, m, 4))
    return fg, bg, a2g_arg, _encode_boxes(anchors[None], matched_gt, var)


def _rank(mask):
    return torch.cumsum(mask.to(torch.int32), dim=-1) - 1


@register_op("rpn_target_assign")
def _rpn_target_assign(ctx, ins, attrs):
    """RPN anchor targets, dense: ScoreTarget (N, M) in {1 fg, 0 bg, -1
    ignore} (int32), LocationTarget (N, M, 4) and BBoxInsideWeight
    (N, M, 4), sampled to rpn_batch_size_per_im in index order."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt, crowd, im_info = ins["GtBoxes"][0], ins["IsCrowd"][0], \
        ins["ImInfo"][0]
    var = ins["AnchorVar"][0].reshape(-1, 4) if ins.get("AnchorVar") \
        else None
    batch_per_im = attrs.get("rpn_batch_size_per_im", 256)
    fg_cap = int(batch_per_im * attrs.get("rpn_fg_fraction", 0.5))
    fg, bg, _, loc_t = _assign(
        anchors, gt, crowd, im_info, attrs.get("rpn_positive_overlap", 0.7),
        attrs.get("rpn_negative_overlap", 0.3),
        attrs.get("rpn_straddle_thresh", 0.0), var)
    fg_keep = fg & (_rank(fg) < fg_cap)
    n_fg = fg_keep.to(torch.int32).sum(dim=1, keepdim=True)
    bg_keep = bg & (_rank(bg) < batch_per_im - n_fg)
    score_t = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1)).to(
        torch.int32)
    w = fg_keep.to(torch.float32)[..., None].expand(-1, -1, 4)
    return {"ScoreTarget": [score_t], "LocationTarget": [loc_t * w],
            "BBoxInsideWeight": [w]}


@register_op("retinanet_target_assign")
def _retinanet_target_assign(ctx, ins, attrs):
    """RetinaNet anchor targets: no sampling; fg rows carry their gt's
    1-indexed class, bg 0, ignore -1 (int32); ForegroundNumber (N, 1)."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt, labels = ins["GtBoxes"][0], ins["GtLabels"][0]
    var = ins["AnchorVar"][0].reshape(-1, 4) if ins.get("AnchorVar") \
        else None
    fg, bg, arg, loc_t = _assign(
        anchors, gt, ins["IsCrowd"][0], ins["ImInfo"][0],
        attrs.get("positive_overlap", 0.5),
        attrs.get("negative_overlap", 0.4), -1.0, var)
    cls = labels.to(torch.int32).gather(1, arg)
    score_t = torch.where(fg, cls, torch.where(bg, 0, -1)).to(torch.int32)
    w = fg.to(torch.float32)[..., None].expand(-1, -1, 4)
    fg_num = fg.to(torch.int32).sum(dim=1, keepdim=True, dtype=torch.int32)
    return {"ScoreTarget": [score_t], "LocationTarget": [loc_t * w],
            "BBoxInsideWeight": [w], "ForegroundNumber": [fg_num]}


_BBOX_CLIP = float(np.log(1000.0 / 16))


def _decode_deltas(t, anc):
    """The RCNN decode of deltas t against anchors (+1 widths, dw/dh
    clipped at log(1000/16))."""
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw / 2
    acy = anc[..., 1] + ah / 2
    cx = t[..., 0] * aw + acx
    cy = t[..., 1] * ah + acy
    bw = torch.exp(jmin(t[..., 2], _BBOX_CLIP)) * aw
    bh = torch.exp(jmin(t[..., 3], _BBOX_CLIP)) * ah
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - 1,
                        cy + bh / 2 - 1], dim=-1)


def _clip_to_image(boxes, imh, imw):
    """boxes (N, K, 4) clipped to [0, im - 1] of their image, imh and imw
    (N, 1)."""
    zero = scalar(0.0, boxes)
    return torch.stack([jclip(boxes[..., 0], zero, imw - 1),
                        jclip(boxes[..., 1], zero, imh - 1),
                        jclip(boxes[..., 2], zero, imw - 1),
                        jclip(boxes[..., 3], zero, imh - 1)], dim=-1)


@register_op("generate_proposals")
def _generate_proposals(ctx, ins, attrs):
    """RPN proposals: deltas decoded against the anchors, clipped to the
    image, boxes under min_size dropped, the pre_nms_topN best, then a
    greedy NMS of exactly post_nms_topN steps (zero rows once the
    candidates run out)."""
    scores = ins["Scores"][0]                        # (N, A, H, W)
    deltas = ins["BboxDeltas"][0]                    # (N, A·4, H, W)
    im_info = ins["ImInfo"][0]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    post_n = attrs.get("post_nms_topN", 1000)
    nms_thresh = attrs.get("nms_thresh", 0.5)
    min_size = attrs.get("min_size", 0.1)
    n, a, h, w = scores.shape
    pre_n = min(attrs.get("pre_nms_topN", 6000), h * w * a)
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
    boxes = _decode_deltas(dl * variances, anchors)
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    scale = jmax(im_info[:, 2:3], 1e-6)
    boxes = _clip_to_image(boxes, imh, imw)
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    keep = (ws >= min_size * scale) & (hs >= min_size * scale)
    neg_inf = scalar(float("-inf"), sc)
    sc = torch.where(keep, sc, neg_inf)
    top_idx = stable_argsort(sc, dim=1, descending=True)[:, :pre_n]
    top_sc = sc.gather(1, top_idx)
    top_boxes = boxes.gather(1, top_idx[..., None].expand(n, pre_n, 4))
    ar = torch.arange(pre_n, device=sc.device)
    cur, rois, probs = top_sc, [], []
    for _ in range(post_n):
        best = torch.argmax(cur, dim=1)
        best_sc = take(cur, best)
        best_box = take(top_boxes, best)
        ious = iou_xyxy(best_box[:, None], top_boxes)[:, 0]
        cur = torch.where((ious > nms_thresh) | (ar[None] == best[:, None]),
                          neg_inf, cur)
        valid = torch.isfinite(best_sc)
        rois.append(torch.where(valid[:, None], best_box,
                                scalar(0.0, best_box)))
        probs.append(torch.where(valid, best_sc, scalar(0.0, best_sc)))
    return {"RpnRois": [torch.stack(rois, dim=1)],
            "RpnRoiProbs": [torch.stack(probs, dim=1)[..., None]]}


@register_op("retinanet_detection_output")
def _retinanet_detection_output(ctx, ins, attrs):
    """RetinaNet decode and NMS: each FPN level's nms_top_k best (box,
    class) scores decoded against that level's anchors, then a
    class-aware greedy NMS of keep_top_k steps over all levels. (N,
    keep_top_k, 6) rows [label, score, x1, y1, x2, y2], label -1
    padding."""
    im_info = ins["ImInfo"][0]
    score_thresh = attrs.get("score_threshold", 0.05)
    nms_top_k = attrs.get("nms_top_k", 1000)
    keep_top_k = attrs.get("keep_top_k", 100)
    nms_thresh = attrs.get("nms_threshold", 0.3)
    all_b, all_s, all_c = [], [], []
    for bb, sc, an in zip(ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        an = an.reshape(-1, 4)
        n, mi, c = sc.shape
        k = min(nms_top_k, mi * c)
        flat = sc.reshape(n, -1)
        idx = stable_argsort(flat, dim=1, descending=True)[:, :k]
        top = flat.gather(1, idx)
        box_idx, cls_idx = idx // c, idx % c
        t = bb.gather(1, box_idx[..., None].expand(n, k, 4))
        # _decode_deltas' arithmetic, but summed in the reference's order
        # for this op: t·w + x1 + w/2
        anc = an[box_idx]
        aw = anc[..., 2] - anc[..., 0] + 1.0
        ah = anc[..., 3] - anc[..., 1] + 1.0
        cx = t[..., 0] * aw + anc[..., 0] + aw / 2
        cy = t[..., 1] * ah + anc[..., 1] + ah / 2
        bw = torch.exp(jmin(t[..., 2], _BBOX_CLIP)) * aw
        bh = torch.exp(jmin(t[..., 3], _BBOX_CLIP)) * ah
        all_b.append(torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - 1,
                                  cy + bh / 2 - 1], dim=-1))
        all_s.append(torch.where(top > score_thresh, top, scalar(-1.0, top)))
        all_c.append(cls_idx)
    boxes = torch.cat(all_b, dim=1)
    scores = torch.cat(all_s, dim=1)
    clses = torch.cat(all_c, dim=1)
    boxes = _clip_to_image(boxes, im_info[:, 0:1], im_info[:, 1:2])
    _, score, box, cls = greedy_nms(scores, boxes, clses, keep_top_k,
                                    nms_thresh, -1.0, iou=iou_xyxy)
    label = torch.where(score > 0, cls + 1, -1).to(boxes.dtype)
    rows = torch.cat([label[..., None], jmax(score, 0.0)[..., None],
                      torch.where((score > 0)[..., None], box,
                                  scalar(0.0, box))], dim=2)
    return {"Out": [rows]}


def _merge_pass(boxes, sc, score_thresh, nms_thresh, iou_fn):
    """The EAST row-order merge of one class over images: boxes (N, M, 4),
    scores (N, M). Consecutive valid boxes overlapping the running
    cluster by more than nms_thresh join it, score-weighted; a box that
    does not join closes the cluster. Returns the closed clusters (N,
    M + 1, 4) and their scores (-1 where none closed)."""
    n, m = sc.shape
    cur_box = boxes.new_zeros((n, 4))
    cur_score = torch.full((n,), -1.0, dtype=boxes.dtype, device=boxes.device)
    have = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    eb, es = [], []
    for j in range(m):
        box, s = boxes[:, j], sc[:, j]
        valid = s > score_thresh
        iou = iou_fn(box[:, None], cur_box[:, None])[:, 0, 0]
        mergeable = have & valid & (iou > nms_thresh)
        w_old = jmax(cur_score, 1e-12)[:, None]
        w_new = jmax(s, 1e-12)[:, None]
        merged_box = (cur_box * w_old + box * w_new) / (w_old + w_new)
        emit = have & valid & ~mergeable
        eb.append(torch.where(emit[:, None], cur_box, scalar(0.0, cur_box)))
        es.append(torch.where(emit, cur_score, scalar(-1.0, cur_score)))
        cur_box = torch.where(mergeable[:, None], merged_box,
                              torch.where(valid[:, None], box, cur_box))
        cur_score = torch.where(mergeable, cur_score + s,
                                torch.where(valid, s, cur_score))
        have = have | valid
    eb.append(cur_box)
    es.append(torch.where(have, cur_score, scalar(-1.0, cur_score)))
    return torch.stack(eb, dim=1), torch.stack(es, dim=1)


@register_op("locality_aware_nms")
def _locality_aware_nms(ctx, ins, attrs):
    """EAST locality-aware NMS: each class's row-order merge pass, then a
    greedy NMS of keep_top_k steps whose threshold decays by nms_eta per
    pick while above 0.5. (N, keep_top_k, 6) rows, label -1 padding."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    score_thresh = attrs["score_threshold"]
    nms_thresh = attrs.get("nms_threshold", 0.3)
    nms_top_k = attrs.get("nms_top_k", -1)
    nms_eta = attrs.get("nms_eta", 1.0)
    keep_top_k = attrs["keep_top_k"]
    background = attrs.get("background_label", -1)
    n, c, m = scores.shape
    iou_fn = iou_matrix if attrs.get("normalized", True) else iou_xyxy
    all_b, all_s, all_c = [], [], []
    for cls in range(c):
        if cls == background:
            continue
        sc = scores[:, cls]
        if nms_top_k is not None and 0 < nms_top_k < m:
            kth = torch.topk(sc, nms_top_k, dim=-1).values[:, -1:]
            sc = torch.where(sc >= kth, sc, scalar(-1.0, sc))
        eb, es = _merge_pass(bboxes, sc, score_thresh, nms_thresh, iou_fn)
        all_b.append(eb)
        all_s.append(es)
        all_c.append(torch.full((m + 1,), cls, dtype=torch.long,
                                device=sc.device))
    flat_box = torch.cat(all_b, dim=1)
    cur = torch.cat(all_s, dim=1)
    flat_cls = torch.cat(all_c)
    ar = torch.arange(flat_cls.shape[0], device=cur.device)
    thresh = torch.full((n,), nms_thresh, dtype=bboxes.dtype,
                        device=cur.device)
    rows = []
    for _ in range(keep_top_k):
        best = torch.argmax(cur, dim=1)
        best_score = take(cur, best)
        best_box = take(flat_box, best)
        best_cls = flat_cls[best]
        ious = iou_fn(best_box[:, None], flat_box)[:, 0]
        suppress = (((ious > thresh[:, None])
                     & (flat_cls[None] == best_cls[:, None]))
                    | (ar[None] == best[:, None]))
        cur = torch.where(suppress, scalar(-1.0, cur), cur)
        if nms_eta < 1.0:
            thresh = torch.where((best_score > 0) & (thresh > 0.5),
                                 thresh * nms_eta, thresh)
        live = best_score > 0
        rows.append(torch.cat([
            torch.where(live, best_cls, -1).to(bboxes.dtype)[:, None],
            jmax(best_score, 0.0)[:, None],
            torch.where(live[:, None], best_box, scalar(0.0, best_box))],
            dim=1))
    return {"Out": [torch.stack(rows, dim=1)]}


@register_op("generate_proposal_labels")
def _generate_proposal_labels(ctx, ins, attrs):
    """Fast-RCNN head sampling, dense: every roi (gt boxes appended; crowd
    and padding gts are no candidates) gets a label (class, 0 bg, -1
    unsampled; int32), encoded targets and inside/outside weights,
    sampled in index order."""
    rois = ins["RpnRois"][0]
    gt_cls = ins["GtClasses"][0].to(torch.int32)
    crowd, gt = ins["IsCrowd"][0], ins["GtBoxes"][0]
    batch_per_im = attrs.get("batch_size_per_im", 256)
    fg_cap = int(batch_per_im * attrs.get("fg_fraction", 0.25))
    weights = table(attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2]),
                    rois.device)
    n, r, g = rois.shape[0], rois.shape[1], gt.shape[1]
    valid_gt = ((gt[..., 2] - gt[..., 0]) > 0) & ~(crowd > 0)
    cand = torch.cat([rois, gt], dim=1)                         # (N, R+G, 4)
    row_valid = torch.cat([torch.ones((n, r), dtype=torch.bool,
                                      device=rois.device), valid_gt], dim=1)
    iou = iou_xyxy(cand, gt)
    iou = torch.where(valid_gt[:, None, :], iou, scalar(-1.0, iou))
    max_iou = iou.amax(dim=2)
    argmax_gt = torch.argmax(iou, dim=2)
    fg = row_valid & (max_iou >= attrs.get("fg_thresh", 0.25))
    bg = row_valid & (max_iou < attrs.get("bg_thresh_hi", 0.5)) \
        & (max_iou >= attrs.get("bg_thresh_lo", 0.0))
    fg_keep = fg & (_rank(fg) < fg_cap)
    n_fg = fg_keep.to(torch.int32).sum(dim=1, keepdim=True)
    bg_keep = bg & (_rank(bg) < batch_per_im - n_fg)
    labels = torch.where(fg_keep, gt_cls.gather(1, argmax_gt),
                         torch.where(bg_keep, 0, -1)).to(torch.int32)
    matched = gt.gather(1, argmax_gt[..., None].expand(n, r + g, 4))
    targets = _encode_boxes(cand, matched) / weights
    w = fg_keep.to(torch.float32)[..., None].expand(-1, -1, 4)
    return {"Rois": [cand], "LabelsInt32": [labels],
            "BboxTargets": [targets * w], "BboxInsideWeights": [w],
            "BboxOutsideWeights": [w]}


@register_op("generate_mask_labels")
def _generate_mask_labels(ctx, ins, attrs):
    """Mask-RCNN targets: each foreground roi's matched polygon rasterised
    into its resolution x resolution grid by an even-odd ray cast over
    the pixel centres (polygons dense (N, G, P, 2) with vertex counts);
    MaskInt32 rows (int32) are -1 for non-foreground rois."""
    gt_cls = ins["GtClasses"][0]
    crowd = ins["IsCrowd"][0]
    segms = ins["GtSegms"][0]                              # (N, G, P, 2)
    lens = ins["GtSegmLens"][0].long()
    rois = ins["Rois"][0]                                  # (N, R, 4)
    lab = ins["LabelsInt32"][0].long()
    num_classes = attrs["num_classes"]
    res = attrs["resolution"]
    n, g, p_max, _ = segms.shape
    r = rois.shape[1]
    dev = rois.device
    valid_gt = (lens >= 3) & ~(crowd > 0)
    vmask = torch.arange(p_max, device=dev)[None, None, :, None] \
        < lens[:, :, None, None]
    inf = scalar(float("inf"), segms)
    lo = torch.where(vmask, segms, inf).amin(dim=2)
    hi = torch.where(vmask, segms, -inf).amax(dim=2)
    iou = iou_xyxy(rois, torch.cat([lo, hi], dim=-1))
    iou = torch.where(valid_gt[:, None, :], iou, scalar(-1.0, iou))
    match = torch.argmax(iou, dim=2)                       # (N, R)
    fg = lab > 0
    poly = segms.gather(1, match[..., None, None].expand(n, r, p_max, 2))
    nverts = lens.gather(1, match)                         # (N, R)
    # rasterise: pixel centres of each roi
    x1, y1, x2, y2 = (rois[..., i] for i in range(4))
    w = jmax(x2 - x1, 1e-6)
    h = jmax(y2 - y1, 1e-6)
    ar = torch.arange(res, device=dev, dtype=rois.dtype) + 0.5
    px = x1[..., None] + ar * w[..., None] / res             # (N, R, res)
    py = y1[..., None] + ar * h[..., None] / res
    gx = px[..., None, :].expand(n, r, res, res)
    gy = py[..., :, None].expand(n, r, res, res)
    vi = poly
    vj = torch.roll(poly, -1, dims=2)
    eidx = torch.arange(p_max, device=dev)
    closing = (eidx[None, None] == (nverts - 1)[..., None])[..., None]
    vj = torch.where(closing, poly[:, :, :1], vj)
    valid_e = eidx[None, None] < nverts[..., None]           # (N, R, P)
    yi, yj = vi[..., 1, None, None], vj[..., 1, None, None]  # (N,R,P,1,1)
    xi, xj = vi[..., 0, None, None], vj[..., 0, None, None]
    gy_, gx_ = gy[:, :, None], gx[:, :, None]                # (N,R,1,res,res)
    crosses = (yi > gy_) != (yj > gy_)
    den = torch.where(torch.abs(yj - yi) < 1e-12, scalar(1e-12, yj), yj - yi)
    t = (gy_ - yi) / den
    x_at = xi + t * (xj - xi)
    hit = crosses & (gx_ < x_at) & valid_e[..., None, None]
    inside = hit.to(torch.int32).sum(dim=2) % 2              # (N,R,res,res)
    oh = (torch.arange(num_classes, device=dev)[None, None]
          == lab[..., None]).to(torch.int32)                 # (N, R, classes)
    full = oh[..., None, None] * inside[:, :, None]
    masks = torch.where(fg[..., None, None, None], full, -1).to(torch.int32)
    return {"MaskRois": [rois], "RoiHasMaskInt32": [fg.to(torch.int32)],
            "MaskInt32": [masks.reshape(n, r, num_classes * res * res)]}


@register_op("roi_perspective_transform")
def _roi_perspective_transform(ctx, ins, attrs):
    """Quad ROIs (R, 8, clockwise from top-left) warped to a th x tw grid
    by the homography of the unit square onto the quad, sampled
    bilinearly (zero outside the map)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    r = rois.shape[0]
    bidx = roi_batch_idx(ins, r, x.device)
    th = attrs.get("transformed_height", 1)
    tw = attrs.get("transformed_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    q = rois.reshape(r, 4, 2) * scale
    p0, p1, p2, p3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s = p0 - p1 + p2 - p3
    d1 = p1 - p2
    d2 = p3 - p2
    den = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    den = torch.where(torch.abs(den) < 1e-12, scalar(1e-12, den), den)
    g = (s[:, 0] * d2[:, 1] - d2[:, 0] * s[:, 1]) / den
    hh = (d1[:, 0] * s[:, 1] - s[:, 0] * d1[:, 1]) / den
    affine = (torch.abs(s) < 1e-9).all(dim=1)
    zero = scalar(0.0, g)
    g = torch.where(affine, zero, g)
    hh = torch.where(affine, zero, hh)
    one = torch.ones_like(g)
    hm = torch.stack([
        torch.stack([p1[:, 0] - p0[:, 0] + g * p1[:, 0],
                     p3[:, 0] - p0[:, 0] + hh * p3[:, 0], p0[:, 0]], dim=1),
        torch.stack([p1[:, 1] - p0[:, 1] + g * p1[:, 1],
                     p3[:, 1] - p0[:, 1] + hh * p3[:, 1], p0[:, 1]], dim=1),
        torch.stack([g, hh, one], dim=1)], dim=1)          # (R, 3, 3)
    us = (torch.arange(tw, device=x.device, dtype=x.dtype) + 0.5) / tw
    vs = (torch.arange(th, device=x.device, dtype=x.dtype) + 0.5) / th
    vg, ug = torch.meshgrid(vs, us, indexing="ij")
    uv1 = torch.stack([ug, vg, torch.ones_like(ug)], dim=-1)  # (th, tw, 3)
    xyw = torch.matmul(uv1[None], hm.transpose(1, 2)[:, None])  # (R,th,tw,3)
    px = xyw[..., 0] / xyw[..., 2]
    py = xyw[..., 1] / xyw[..., 2]
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    wx = (px - x0)[:, None]
    wy = (py - y0)[:, None]

    def at(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = points(x, bidx, yy.clamp(0, h - 1).long(),
                    xx.clamp(0, w - 1).long())
        return v * inb[:, None].to(x.dtype)

    out = (at(y0, x0) * (1 - wy) * (1 - wx)
           + at(y0, x0 + 1) * (1 - wy) * wx
           + at(y0 + 1, x0) * wy * (1 - wx)
           + at(y0 + 1, x0 + 1) * wy * wx)
    return {"Out": [out]}


@register_op("detection_map")
def _detection_map(ctx, ins, attrs):
    """VOC mAP over one padded batch: DetectRes (N, D, 6) [label score x1
    y1 x2 y2] (label -1 padding), Label (N, G, 5|6) [label x1 y1 x2 y2
    (difficult)]. Per class, the detections in global score order are
    matched greedily to their image's unmatched gts (a loop of N·D
    steps); integral or 11-point AP; classes without gts skipped."""
    det, gt = ins["DetectRes"][0], ins["Label"][0]
    class_num = attrs["class_num"]
    background = attrs.get("background_label", 0)
    ov_thresh = attrs.get("overlap_threshold", 0.5)
    eval_difficult = attrs.get("evaluate_difficult", True)
    ap_version = attrs.get("ap_type", "integral")
    n, d_cap = det.shape[0], det.shape[1]
    g_cap = gt.shape[1]
    dev = det.device
    gt_label = gt[..., 0].to(torch.int32)
    gt_boxes = gt[..., 1:5]
    difficult = gt[..., 5] > 0 if gt.shape[-1] > 5 else \
        torch.zeros(gt_label.shape, dtype=torch.bool, device=dev)
    gt_valid = gt_label >= 0
    gt_count = gt_valid & ~difficult if not eval_difficult else gt_valid
    det_label = det[..., 0].to(torch.int32)
    det_score = det[..., 1]
    det_boxes = det[..., 2:6]
    det_valid = det_label >= 0
    # every detection against every gt of its image: (N, D, G)
    ious_all = iou_matrix(det_boxes, gt_boxes)
    aps, has_gt = [], []
    for c in range(class_num):
        if c == background:
            continue
        cls_det = det_valid & (det_label == c)
        flat_score = torch.where(cls_det, det_score,
                                 scalar(float("-inf"), det_score)).reshape(-1)
        order = stable_argsort(flat_score, dim=0, descending=True)
        cls_gt = gt_count & (gt_label == c)
        cls_diff = (gt_label == c) & difficult
        npos = cls_gt.to(torch.float32).sum()
        matched = torch.zeros((n, g_cap), dtype=torch.bool, device=dev)
        rows = torch.arange(n, device=dev)
        tps, fps = [], []
        for j in range(n * d_cap):
            od = order[j:j + 1]
            i = od // d_cap
            ious = row(ious_all.reshape(n * d_cap, g_cap), od)  # (G,)
            cand = row(cls_gt, i) & ~row(matched, i) & (ious >= ov_thresh)
            ious_m = torch.where(cand, ious, scalar(-1.0, ious))
            best = torch.argmax(ious_m)
            hit = row(ious_m, best) >= 0
            valid = torch.isfinite(row(flat_score, od))
            diff_hit = (row(cls_diff, i) & (ious >= ov_thresh)).any() \
                & (not eval_difficult)
            tp = valid & hit
            fps.append((valid & ~hit & ~diff_hit).to(torch.float32))
            tps.append(tp.to(torch.float32))
            matched = matched | ((rows[:, None] == i)
                                 & (torch.arange(g_cap, device=dev)[None]
                                    == best) & tp)
        cum_tp = torch.cumsum(torch.stack(tps), dim=0)
        cum_fp = torch.cumsum(torch.stack(fps), dim=0)
        recall = cum_tp / jmax(npos, 1.0)
        precision = cum_tp / jmax(cum_tp + cum_fp, 1e-10)
        zero = scalar(0.0, precision)
        if ap_version == "11point":
            pts = [torch.where(recall >= t, precision, zero).amax()
                   for t in np.arange(0.0, 1.01, 0.1)]
            ap = torch.stack(pts).mean()
        else:
            prev = torch.cat([recall.new_zeros(1), recall[:-1]])
            ap = ((recall - prev) * precision).sum()
        aps.append(torch.where(npos > 0, ap, zero))
        has_gt.append((npos > 0).to(torch.float32))
    ap_sum = torch.stack(aps).sum()
    return {"MAP": [ap_sum / jmax(torch.stack(has_gt).sum(), 1.0)]}
