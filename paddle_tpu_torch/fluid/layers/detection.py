"""Detection layers (ref: python/paddle/fluid/layers/detection.py): box
coding, IoU, priors, yolo, NMS (static-shape top-k form), the R-CNN and
RetinaNet target assigns and heads, and the SSD and YOLO losses composed
from primitives. Port of paddle_tpu/fluid/layers/detection.py: the same
28 names, signatures, ops and attrs, so both packages build the same
Program; the ops are lowered by paddle_tpu_torch/ops/detection_ops.py and
rcnn_ops.py.
"""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "box_coder", "iou_similarity", "prior_box", "yolo_box", "yolov3_loss",
    "multiclass_nms", "bipartite_match", "ssd_loss", "density_prior_box",
    "box_clip", "detection_output", "anchor_generator", "sigmoid_focal_loss",
    "rpn_target_assign", "retinanet_target_assign", "generate_proposals",
    "target_assign", "detection_map", "polygon_box_transform",
    "box_decoder_and_assign", "multi_box_head", "retinanet_detection_output",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "locality_aware_nms", "generate_proposal_labels",
    "roi_perspective_transform", "generate_mask_labels",
]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_variable_for_type_inference(target_box.dtype)
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, Variable):
        ins["PriorBoxVar"] = [prior_box_var]
    elif isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = list(prior_box_var)
    helper.append_op(
        type="box_coder", inputs=ins, outputs={"OutputBox": [out]},
        attrs=attrs,
    )
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and y.shape is not None:
        out.shape = (x.shape[0], y.shape[0])
    helper.append_op(
        type="iou_similarity",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"box_normalized": box_normalized},
    )
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.0],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", **locals())
    box = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and len(input.shape) == 4:
        ars = list(aspect_ratios)
        n_ar = len(ars) + sum(1 for r in ars if flip and abs(r - 1.0) > 1e-6)
        np_per_cell = len(min_sizes) * n_ar + len(max_sizes or [])
        box.shape = (input.shape[2], input.shape[3], np_per_cell, 4)
        var.shape = box.shape
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [box], "Variances": [var]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variance),
            "flip": flip,
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
        },
    )
    return box, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=[0.1, 0.1, 0.2, 0.2],
                      clip=False, steps=[0.0, 0.0], offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", **locals())
    box = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [box], "Variances": [var]},
        attrs={
            "densities": list(densities or [1]),
            "fixed_sizes": list(fixed_sizes or [1.0]),
            "fixed_ratios": list(fixed_ratios or [1.0]),
            "variances": list(variance),
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
            "flatten_to_2d": flatten_to_2d,
        },
    )
    return box, var


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None):
    helper = LayerHelper("yolo_box", **locals())
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="yolo_box",
        inputs={"X": [x], "ImgSize": [img_size]},
        outputs={"Boxes": [boxes], "Scores": [scores]},
        attrs={
            "anchors": list(anchors),
            "class_num": class_num,
            "conf_thresh": conf_thresh,
            "downsample_ratio": downsample_ratio,
        },
    )
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """YOLOv3 loss composed from primitives (ref yolov3_loss_op.cc):
    coordinate MSE + objectness/class BCE on responsible anchors."""
    from . import nn, tensor, loss as loss_layers

    helper = LayerHelper("yolov3_loss", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (x.shape[0],)
    helper.append_op(
        type="yolov3_loss",
        inputs={"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]},
        outputs={"Loss": [out]},
        attrs={
            "anchors": list(anchors),
            "anchor_mask": list(anchor_mask),
            "class_num": class_num,
            "ignore_thresh": ignore_thresh,
            "downsample_ratio": downsample_ratio,
        },
    )
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    """Static-shape NMS: returns exactly keep_top_k rows per image as
    (label, score, x1, y1, x2, y2), padded with label=-1 (the static-shape
    form of the reference's variable-length LoD output)."""
    helper = LayerHelper("multiclass_nms", **locals())
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    if bboxes.shape is not None:
        out.shape = (bboxes.shape[0], keep_top_k, 6)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "nms_threshold": nms_threshold,
            "nms_eta": nms_eta,
            "normalized": normalized,
            "background_label": background_label,
        },
    )
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    if return_index:
        raise NotImplementedError(
            "detection_output(return_index=True): the static-shape "
            "NMS emits fixed keep_top_k rows per image (padded with "
            "label=-1), so there is no LoD row-index companion; consume "
            "the padded rows directly or filter on label >= 0.")
    if nms_eta != 1.0:
        raise NotImplementedError(
            "detection_output(nms_eta != 1): adaptive NMS decays the "
            "threshold per kept box, which is inherently sequential; the "
            "vectorized NMS here supports only the standard nms_eta=1.0, as "
            "the reference's layer does")
    decoded = box_coder(
        prior_box, prior_box_var, loc, code_type="decode_center_size"
    )
    return multiclass_nms(
        decoded, scores, score_threshold, nms_top_k, keep_top_k,
        nms_threshold, background_label=background_label,
    )


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    """Faster-RCNN anchors (ref detection.py:2259): (H, W, A, 4) absolute
    xyxy anchors + broadcast variances; A = len(sizes) * len(ratios),
    aspect_ratios loop outer."""
    if not isinstance(anchor_sizes, (list, tuple)):
        anchor_sizes = [anchor_sizes]
    if not isinstance(aspect_ratios, (list, tuple)):
        aspect_ratios = [aspect_ratios]
    if not (isinstance(stride, (list, tuple)) and len(stride) == 2):
        raise ValueError(
            "anchor_generator: stride must be a 2-list (stride_w, stride_h)"
        )
    helper = LayerHelper("anchor_generator", **locals())
    anchor = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    na = len(anchor_sizes) * len(aspect_ratios)
    if input.shape is not None and len(input.shape) == 4:
        anchor.shape = (input.shape[2], input.shape[3], na, 4)
        var.shape = anchor.shape
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input]},
        outputs={"Anchors": [anchor], "Variances": [var]},
        attrs={
            "anchor_sizes": list(map(float, anchor_sizes)),
            "aspect_ratios": list(map(float, aspect_ratios)),
            "variances": list(variance),
            "stride": list(map(float, stride)),
            "offset": offset,
        },
    )
    anchor.stop_gradient = True
    var.stop_gradient = True
    return anchor, var


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25):
    """Focal loss for RetinaNet (ref detection.py:436): elementwise
    (R, C) loss; label is the 1-indexed class per row (0 bg, -1 ignore),
    normalized by fg_num."""
    helper = LayerHelper("sigmoid_focal_loss", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type="sigmoid_focal_loss",
        inputs={"X": [x], "Label": [label], "FgNum": [fg_num]},
        outputs={"Out": [out]},
        attrs={"gamma": float(gamma), "alpha": float(alpha)},
    )
    return out


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """RPN target assign (ref detection.py:289), dense form:
    instead of the reference's gathered LoD subsets this returns the FULL
    per-anchor tensors —
      (score_pred (N,M,1), loc_pred (N,M,4), score_target (N,M) in
       {1,0,-1}, loc_target (N,M,4), bbox_inside_weight (N,M,4))
    — apply score_target >= 0 as the cls-loss mask and the inside weight
    on the reg loss. gt_boxes is the zero-padded (N, G, 4) dense batch.
    Sampling is deterministic (the reference's use_random=False rule)."""
    helper = LayerHelper("rpn_target_assign", **locals())
    score_t = helper.create_variable_for_type_inference("int32")
    loc_t = helper.create_variable_for_type_inference(gt_boxes.dtype)
    w = helper.create_variable_for_type_inference(gt_boxes.dtype)
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "IsCrowd": [is_crowd], "ImInfo": [im_info]}
    if anchor_var is not None:
        ins["AnchorVar"] = [anchor_var]
    helper.append_op(
        type="rpn_target_assign",
        inputs=ins,
        outputs={"ScoreTarget": [score_t], "LocationTarget": [loc_t],
                 "BBoxInsideWeight": [w]},
        attrs={
            "rpn_batch_size_per_im": rpn_batch_size_per_im,
            "rpn_straddle_thresh": rpn_straddle_thresh,
            "rpn_fg_fraction": rpn_fg_fraction,
            "rpn_positive_overlap": rpn_positive_overlap,
            "rpn_negative_overlap": rpn_negative_overlap,
        },
    )
    for v in (score_t, loc_t, w):
        v.stop_gradient = True
    return cls_logits, bbox_pred, score_t, loc_t, w


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet target assign (ref detection.py:65), dense form (see
    rpn_target_assign): returns (score_pred, loc_pred, score_target with
    1-indexed class labels / 0 bg / -1 ignore, loc_target,
    bbox_inside_weight, fg_num (N,1))."""
    helper = LayerHelper("retinanet_target_assign", **locals())
    score_t = helper.create_variable_for_type_inference("int32")
    loc_t = helper.create_variable_for_type_inference(gt_boxes.dtype)
    w = helper.create_variable_for_type_inference(gt_boxes.dtype)
    fg_num = helper.create_variable_for_type_inference("int32")
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "GtLabels": [gt_labels], "IsCrowd": [is_crowd],
           "ImInfo": [im_info]}
    if anchor_var is not None:
        ins["AnchorVar"] = [anchor_var]
    helper.append_op(
        type="retinanet_target_assign",
        inputs=ins,
        outputs={"ScoreTarget": [score_t], "LocationTarget": [loc_t],
                 "BBoxInsideWeight": [w], "ForegroundNumber": [fg_num]},
        attrs={
            "positive_overlap": positive_overlap,
            "negative_overlap": negative_overlap,
        },
    )
    for v in (score_t, loc_t, w, fg_num):
        v.stop_gradient = True
    return cls_logits, bbox_pred, score_t, loc_t, w, fg_num


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposals (ref detection.py:2713). Static-shape output: exactly
    (N, post_nms_top_n, 4) rois + (N, post_nms_top_n, 1) probs, zero-padded
    (the reference emits variable-length LoD)."""
    helper = LayerHelper("generate_proposals", **locals())
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    if scores.shape is not None:
        rois.shape = (scores.shape[0], post_nms_top_n, 4)
        probs.shape = (scores.shape[0], post_nms_top_n, 1)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs]},
        attrs={
            "pre_nms_topN": pre_nms_top_n,
            "post_nms_topN": post_nms_top_n,
            "nms_thresh": nms_thresh,
            "min_size": min_size,
            "eta": eta,
        },
    )
    return rois, probs


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Dense target assign (ref detection.py:1286): input is the padded
    per-image gt tensor (N, G, K) (LoD rows -> batch dim); negative_indices
    is a dense (N, P) mask tensor (entries >= 0 mark negative slots)."""
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    w = helper.create_variable_for_type_inference("float32")
    ins = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        ins["NegIndices"] = [negative_indices]
    helper.append_op(
        type="target_assign",
        inputs=ins,
        outputs={"Out": [out], "OutWeight": [w]},
        attrs={"mismatch_value": mismatch_value or 0.0},
    )
    return out, w


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """Batch mAP (ref detection.py:1105): detect_res is the padded
    (N, D, 6) NMS output, label the padded (N, G, 5|6) gt. Cross-batch
    state accumulation (input_states) is not carried through the graph —
    use fluid.metrics.DetectionMAP for streaming evaluation."""
    if input_states is not None or out_states is not None:
        raise NotImplementedError(
            "detection_map: streaming states are host-side; "
            "accumulate with fluid.metrics.DetectionMAP instead"
        )
    helper = LayerHelper("detection_map", **locals())
    out = helper.create_variable_for_type_inference("float32")
    out.shape = ()
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": [detect_res], "Label": [label]},
        outputs={"MAP": [out]},
        attrs={
            "class_num": class_num,
            "background_label": background_label,
            "overlap_threshold": overlap_threshold,
            "evaluate_difficult": evaluate_difficult,
            "ap_type": ap_version,
        },
    )
    return out


def polygon_box_transform(input, name=None):
    """EAST geometry offsets -> absolute quad coords (ref detection.py:858)."""
    helper = LayerHelper("polygon_box_transform", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="polygon_box_transform",
        inputs={"Input": [input]},
        outputs={"Output": [out]},
    )
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    """Cascade-RCNN per-class decode + argmax assign (ref detection.py:3358)."""
    helper = LayerHelper("box_decoder_and_assign", **locals())
    decoded = helper.create_variable_for_type_inference(prior_box.dtype)
    assigned = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(
        type="box_decoder_and_assign",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box], "BoxScore": [box_score]},
        outputs={"DecodeBox": [decoded], "OutputAssignBox": [assigned]},
        attrs={"box_clip": box_clip},
    )
    return decoded, assigned


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet decode + NMS (ref detection.py:2877): bboxes/scores/anchors
    are per-FPN-level lists. Static-shape output (N, keep_top_k, 6), rows
    [label, score, x1, y1, x2, y2], padded with label=-1."""
    helper = LayerHelper("retinanet_detection_output", **locals())
    out = helper.create_variable_for_type_inference(bboxes[0].dtype)
    if bboxes[0].shape is not None:
        out.shape = (bboxes[0].shape[0], keep_top_k, 6)
    helper.append_op(
        type="retinanet_detection_output",
        inputs={"BBoxes": list(bboxes), "Scores": list(scores),
                "Anchors": list(anchors), "ImInfo": [im_info]},
        outputs={"Out": [out]},
        attrs={
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "nms_threshold": nms_threshold,
            "nms_eta": nms_eta,
        },
    )
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD multi-box head (ref detection.py:1970): per feature map, a conv
    for locations (A*4 ch) and confidences (A*C ch) + prior boxes; outputs
    concatenated (N, total_priors, 4) locs, (N, total_priors, C) confs,
    (total_priors, 4) boxes and variances."""
    from . import nn, tensor

    n_in = len(inputs)
    if min_sizes is None:
        # evenly spread ratios between min_ratio and max_ratio (percent)
        min_sizes, max_sizes = [], []
        if n_in > 2:
            step = int(np.floor((max_ratio - min_ratio) / (n_in - 2)))
        else:
            step = 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes
        min_sizes = min_sizes[:n_in]
        max_sizes = max_sizes[:n_in]

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i]
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        if steps is not None:
            st = steps[i] if isinstance(steps[i], (list, tuple)) \
                else [steps[i], steps[i]]
        elif step_w is not None:
            st = [step_w[i], step_h[i]]
        else:
            st = [0.0, 0.0]
        box, var = prior_box(
            feat, image, [ms] if not isinstance(ms, (list, tuple)) else ms,
            [mx] if mx and not isinstance(mx, (list, tuple)) else mx,
            ar, variance, flip, clip, st, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order,
        )
        n_ar = len(ar) + sum(
            1 for r in ar if flip and abs(r - 1.0) > 1e-6
        )
        ms_list = ms if isinstance(ms, (list, tuple)) else [ms]
        mx_list = (mx if isinstance(mx, (list, tuple)) else [mx]) \
            if mx else []
        num_priors = len(ms_list) * n_ar + len(mx_list)
        loc = nn.conv2d(feat, num_priors * 4, kernel_size, stride=stride,
                        padding=pad)
        conf = nn.conv2d(feat, num_priors * num_classes, kernel_size,
                         stride=stride, padding=pad)
        # NCHW -> NHWC -> (N, priors_on_map, K)
        loc = nn.transpose(loc, [0, 2, 3, 1])
        conf = nn.transpose(conf, [0, 2, 3, 1])
        locs.append(nn.reshape(loc, [0, -1, 4]))
        confs.append(nn.reshape(conf, [0, -1, num_classes]))
        boxes_l.append(nn.reshape(box, [-1, 4]))
        vars_l.append(nn.reshape(var, [-1, 4]))

    mbox_locs = tensor.concat(locs, axis=1)
    mbox_confs = tensor.concat(confs, axis=1)
    boxes = tensor.concat(boxes_l, axis=0)
    variances = tensor.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    """FPN level routing (ref detection.py:3274), static form: every output
    level keeps the full (R, 4) shape with non-member rows zeroed (the
    reference emits variable-length LoD splits). restore_ind[i] is the row
    of input roi i inside concat(outs) — i.e. (level_i - min_level) * R + i
    — so gather(concat(head_outs), restore_ind) restores input order, as
    with the reference's restore index."""
    from . import nn, tensor
    from . import ops as act_ops

    num_level = max_level - min_level + 1
    w = nn.elementwise_sub(
        nn.slice(fpn_rois, [1], [2], [3]), nn.slice(fpn_rois, [1], [0], [1])
    )
    h = nn.elementwise_sub(
        nn.slice(fpn_rois, [1], [3], [4]), nn.slice(fpn_rois, [1], [1], [2])
    )
    scale = act_ops.sqrt(nn.elementwise_mul(w, h))
    # level = floor(refer_level + log2(scale / refer_scale))
    log2_ratio = nn.elementwise_div(
        nn.log(nn.elementwise_max(
            nn.scale(scale, scale=1.0 / refer_scale),
            tensor.fill_constant([1], "float32", 1e-6),
        )),
        tensor.fill_constant([1], "float32", float(np.log(2.0))),
    )
    lvl = act_ops.floor(
        nn.scale(log2_ratio, scale=1.0, bias=float(refer_level))
    )
    lvl = nn.clip(lvl, float(min_level), float(max_level))
    from .control_flow import equal

    outs = []
    for i in range(num_level):
        mask = tensor.cast(
            equal(lvl, tensor.fill_constant([1], "float32",
                                            float(min_level + i))),
            "float32",
        )
        outs.append(nn.elementwise_mul(fpn_rois, mask))
    r = fpn_rois.shape[0] if fpn_rois.shape else None
    if r in (None, -1):
        raise ValueError(
            "distribute_fpn_proposals needs a static roi count to build "
            "the restore index (rois come from the static-shape "
            "generate_proposals output)"
        )
    row_in_batch = tensor.assign(np.arange(r, dtype="float32")[:, None])
    restore_ind = tensor.cast(
        nn.elementwise_add(
            nn.scale(
                nn.elementwise_sub(
                    lvl,
                    tensor.fill_constant([1], "float32", float(min_level)),
                ),
                scale=float(r),
            ),
            row_in_batch,
        ),
        "int32",
    )
    return outs, restore_ind


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    """FPN proposal collection (ref detection.py:3423): concat per-level
    rois/scores and keep the global top post_nms_top_n by score (static
    (post_nms_top_n, 4) output). Inputs are per-level (R_i, 4) rois with
    (R_i, 1) scores; slice the batch dim off generate_proposals outputs
    first (its rois are (N, P, 4))."""
    from . import nn, tensor

    num_level = max_level - min_level + 1
    for v in list(multi_rois[:num_level]) + list(multi_scores[:num_level]):
        if v.shape is not None and len(v.shape) > 2:
            raise ValueError(
                "collect_fpn_proposals takes per-image (R, 4)/(R, 1) "
                "levels; got rank-%d %r — slice the batch dim first"
                % (len(v.shape), v.name)
            )
    rois = tensor.concat(multi_rois[:num_level], axis=0)
    scores = tensor.concat(multi_scores[:num_level], axis=0)
    flat = nn.reshape(scores, [-1])
    _, idx = nn.topk(flat, post_nms_top_n)
    return nn.gather(rois, idx)


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """EAST locality-aware NMS (ref detection.py:3156): merge pass over
    row-ordered boxes, then greedy NMS. Static (N, keep_top_k, 6) output
    with label=-1 padding."""
    helper = LayerHelper("locality_aware_nms", **locals())
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    if bboxes.shape is not None:
        out.shape = (bboxes.shape[0], keep_top_k, 6)
    helper.append_op(
        type="locality_aware_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "nms_threshold": nms_threshold,
            "normalized": normalized,
            "nms_eta": nms_eta,
            "background_label": background_label,
        },
    )
    return out


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    """Fast-RCNN roi sampling (ref detection.py:2441), dense static form:
    every roi (gt boxes appended) gets a label (class / 0 bg / -1
    unsampled), encoded bbox targets and inside/outside weights —
    downstream losses mask with the weights instead of gathering.
    Sampling is deterministic (the reference's use_random=False rule)."""
    helper = LayerHelper("generate_proposal_labels", **locals())
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    targets = helper.create_variable_for_type_inference(rpn_rois.dtype)
    w_in = helper.create_variable_for_type_inference(rpn_rois.dtype)
    w_out = helper.create_variable_for_type_inference(rpn_rois.dtype)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
                "ImInfo": [im_info]},
        outputs={"Rois": [rois], "LabelsInt32": [labels],
                 "BboxTargets": [targets],
                 "BboxInsideWeights": [w_in],
                 "BboxOutsideWeights": [w_out]},
        attrs={
            "batch_size_per_im": batch_size_per_im,
            "fg_fraction": fg_fraction,
            "fg_thresh": fg_thresh,
            "bg_thresh_hi": bg_thresh_hi,
            "bg_thresh_lo": bg_thresh_lo,
            "bbox_reg_weights": list(bbox_reg_weights),
        },
    )
    for v in (rois, labels, targets, w_in, w_out):
        v.stop_gradient = True
    return rois, labels, targets, w_in, w_out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_segm_lens=None):
    """Mask-RCNN mask targets (ref detection.py:2568). Dense form:
    gt_segms is the padded (N, G, P, 2) polygon tensor with per-gt vertex
    counts in gt_segm_lens (the reference's 2-level LoD polygons);
    returns (mask_rois, roi_has_mask_int32, mask_int32) with static
    shapes — mask_int32 rows are -1 for non-foreground rois."""
    if gt_segm_lens is None:
        raise ValueError(
            "generate_mask_labels needs gt_segm_lens (per-gt polygon "
            "vertex counts; the dense form of the reference's LoD)"
        )
    helper = LayerHelper("generate_mask_labels", **locals())
    mask_rois = helper.create_variable_for_type_inference(rois.dtype)
    has_mask = helper.create_variable_for_type_inference("int32")
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="generate_mask_labels",
        inputs={"ImInfo": [im_info], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
                "GtSegmLens": [gt_segm_lens], "Rois": [rois],
                "LabelsInt32": [labels_int32]},
        outputs={"MaskRois": [mask_rois],
                 "RoiHasMaskInt32": [has_mask],
                 "MaskInt32": [mask]},
        attrs={"num_classes": num_classes, "resolution": resolution},
    )
    for v in (mask_rois, has_mask, mask):
        v.stop_gradient = True
    return mask_rois, has_mask, mask


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              name=None, rois_batch_idx=None):
    """Perspective-warp quad rois (ref detection.py:2360). rois are
    (R, 8) quads; companion rois_batch_idx (R,) int32 maps each roi to
    its batch image (LoD → dense)."""
    helper = LayerHelper("roi_perspective_transform", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and rois.shape is not None:
        out.shape = (rois.shape[0], input.shape[1], transformed_height,
                     transformed_width)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op(
        type="roi_perspective_transform",
        inputs=ins,
        outputs={"Out": [out]},
        attrs={
            "transformed_height": transformed_height,
            "transformed_width": transformed_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", **locals())
    match_idx = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={
            "ColToRowMatchIndices": [match_idx],
            "ColToRowMatchDist": [match_dist],
        },
        attrs={"match_type": match_type or "bipartite"},
    )
    return match_idx, match_dist


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="box_clip",
        inputs={"Input": [input], "ImInfo": [im_info]},
        outputs={"Output": [out]},
    )
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """SSD multibox loss composed from primitives (ref detection.py
    ssd_loss): per-prior gt matching by IoU, smooth-L1 on matched encoded
    offsets, softmax cross-entropy against matched labels (background for
    unmatched priors), with negatives down-weighted in place of the
    reference's hard-negative mining (static shapes)."""
    from . import nn, loss as loss_layers, tensor

    iou = iou_similarity(gt_box, prior_box)          # (n_gt, n_prior)
    best_iou = nn.reduce_max(iou, dim=[0])           # (n_prior,)
    best_gt = tensor.argmax(iou, axis=0)             # (n_prior,) gt index
    # bipartite step (ref bipartite_match): every gt claims its best prior
    # even below the threshold, expressed as a dense one-hot claim matrix
    best_prior = tensor.argmax(iou, axis=1)          # (n_gt,)
    claims = nn.one_hot(
        nn.unsqueeze(tensor.cast(best_prior, "int64"), [1]), iou.shape[1]
    )                                                # (n_gt, n_prior)
    bi_mask = nn.reduce_max(claims, dim=[0])         # (n_prior,)
    best_gt_bi = tensor.argmax(
        nn.elementwise_mul(iou, claims), axis=0
    )
    thr_mask = tensor.cast(
        nn._layer(
            "greater_equal",
            {"X": best_iou,
             "Y": tensor.fill_constant([1], "float32", overlap_threshold)},
            out_dtype="bool", out_shape=best_iou.shape,
        ),
        "float32",
    )
    if match_type == "bipartite":
        pos_mask = bi_mask
        best_gt = best_gt_bi
    elif match_type == "per_prediction":
        pos_mask = nn.elementwise_max(thr_mask, bi_mask)
        bi_i = tensor.cast(bi_mask, "int64")
        not_bi = tensor.cast(
            nn.scale(bi_mask, scale=-1.0, bias=1.0), "int64"
        )
        best_gt = nn.elementwise_add(
            nn.elementwise_mul(bi_i, best_gt_bi),
            nn.elementwise_mul(not_bi, best_gt),
        )
    else:
        raise ValueError(
            "ssd_loss: match_type must be 'per_prediction' or 'bipartite', "
            "got %r" % (match_type,)
        )
    # localization: smooth-L1 of predicted offsets vs the MATCHED gt's
    # encoded offsets (gather the per-prior matched row of the encode
    # matrix: encoded[gt, prior] -> take diag of gathered rows)
    encoded = box_coder(prior_box, prior_box_var or [0.1, 0.1, 0.2, 0.2],
                        gt_box)                      # (n_gt, n_prior, 4)
    n_prior = prior_box.shape[0] if prior_box.shape else None
    if n_prior in (None, -1):
        raise ValueError(
            "ssd_loss needs a static prior count (priors are build-time "
            "constants); declare prior_box with a concrete first dim"
        )
    enc_matched = nn.gather_nd(
        encoded,
        nn.stack(
            [best_gt,
             tensor.cast(
                 nn._layer(
                     "range", {}, {"start": 0.0, "end": float(n_prior),
                                   "step": 1.0, "dtype": "int64"},
                     out_dtype="int64", out_shape=(n_prior,),
                 ),
                 "int64",
             )],
            axis=1,
        ),
    )                                                # (n_prior, 4)
    loc_l = nn.reduce_sum(
        nn.elementwise_mul(
            nn.reduce_sum(
                loss_layers.huber_loss(location, enc_matched, 1.0), dim=[-1]
            ),
            pos_mask,
        )
    )
    # classification: matched gt label where positive, background otherwise
    matched_label = nn.gather(gt_label, best_gt)     # (n_prior, 1)
    bg = tensor.fill_constant_batch_size_like(
        matched_label, [-1, 1], "int64", float(background_label)
    )
    target_label = nn.elementwise_add(
        nn.elementwise_mul(
            matched_label, tensor.cast(nn.unsqueeze(pos_mask, [1]), "int64")
        ),
        nn.elementwise_mul(
            bg,
            tensor.cast(
                nn.unsqueeze(nn.scale(pos_mask, -1.0, bias=1.0), [1]),
                "int64",
            ),
        ),
    )
    ce = loss_layers.softmax_with_cross_entropy(confidence, target_label)
    ce_flat = nn.squeeze(ce, [1])                    # (n_prior,)
    if mining_type != "max_negative":
        raise NotImplementedError(
            "ssd_loss: mining_type='%s' unsupported; the reference default "
            "'max_negative' (per-image hard-negative mining) is implemented"
            % mining_type
        )
    # hard-negative mining (ref mine_hard_examples, max_negative mode):
    # candidates are non-positive priors whose best IoU < neg_overlap;
    # keep the neg_pos_ratio * num_pos highest-loss candidates (capped by
    # sample_size), all with static shapes — the count is a traced scalar
    # compared against each candidate's rank.
    neg_cand = nn.elementwise_mul(
        nn.scale(pos_mask, scale=-1.0, bias=1.0),
        tensor.cast(
            nn._layer(
                "less_than",
                {"X": best_iou,
                 "Y": tensor.fill_constant([1], "float32", neg_overlap)},
                out_dtype="bool", out_shape=best_iou.shape,
            ),
            "float32",
        ),
    )
    masked = nn.elementwise_sub(
        nn.elementwise_mul(ce_flat, neg_cand),
        nn.scale(nn.scale(neg_cand, scale=-1.0, bias=1.0), scale=1e9),
    )
    # rank of each prior among candidates by loss desc = double argsort
    _, order = tensor.argsort(masked, descending=True)
    _, rank = tensor.argsort(tensor.cast(order, "float32"))
    num_pos = nn.reduce_sum(pos_mask)
    neg_count = nn.elementwise_min(
        nn.scale(num_pos, scale=float(neg_pos_ratio)),
        nn.reduce_sum(neg_cand),
    )
    if sample_size is not None:
        neg_count = nn.elementwise_min(
            neg_count, tensor.fill_constant([], "float32", float(sample_size))
        )
    neg_mask = nn.elementwise_mul(
        tensor.cast(
            nn._layer(
                "less_than",
                {"X": tensor.cast(rank, "float32"), "Y": neg_count},
                out_dtype="bool", out_shape=best_iou.shape,
            ),
            "float32",
        ),
        neg_cand,
    )
    conf_l = nn.reduce_sum(
        nn.elementwise_mul(ce_flat, nn.elementwise_add(pos_mask, neg_mask))
    )
    total = nn.elementwise_add(
        nn.scale(loc_l, scale=loc_loss_weight),
        nn.scale(conf_l, scale=conf_loss_weight),
    )
    if normalize:
        n_pos = nn.reduce_sum(pos_mask)
        total = nn.elementwise_div(
            total, nn.elementwise_max(
                n_pos, tensor.fill_constant([], "float32", 1.0)
            )
        )
    return total
