"""The detection slice's op lowerings and layers against the JAX package, on
the CPU.

- The 14 detection op types (``paddle_tpu/ops/detection_ops.py``), the 14
  RCNN op types (``rcnn_ops.py``) and the three SSD's loss needs beside
  them (``one_hot``, ``argsort``, ``huber_loss``): each port lowering
  against the JAX lowering on the same seeded numpy inputs and attrs.
  Integer and bool results, and the priors, are equal bit for bit (int64
  in the port where jax without x64 gives int32, ROADMAP.md Queue 3);
  float results within FWD_TOL (1e-6) of the largest value. Gradients
  through torch.autograd against jax.vjp under one random cotangent,
  within GRAD_TOL (1e-5) of the largest JAX gradient.
  The R-CNN cases run in tests/test_torch_rcnn.py, which also runs the
  reference's own detection tests against the port.
- Ties resolve as in the reference: NMS and ``bipartite_match`` over tied
  scores, ``argsort`` over ties and signed zeros (stable, ascending index
  order in both directions), ``one_hot`` of out-of-range ids (zero rows).
- Every detection layer, and the ROI, ``deformable_conv``, ``one_hot``,
  ``argsort`` and ``huber_loss`` layers, build the same Program JSON in
  both packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

DETECTION_OPS = (
    "roi_pool", "roi_align", "psroi_pool", "prroi_pool", "deformable_conv",
    "box_coder", "iou_similarity", "prior_box", "density_prior_box",
    "yolo_box", "box_clip", "multiclass_nms", "bipartite_match",
    "yolov3_loss")
RCNN_OPS = (
    "anchor_generator", "sigmoid_focal_loss", "polygon_box_transform",
    "box_decoder_and_assign", "target_assign", "rpn_target_assign",
    "retinanet_target_assign", "generate_proposals",
    "retinanet_detection_output", "locality_aware_nms",
    "generate_proposal_labels", "generate_mask_labels",
    "roi_perspective_transform", "detection_map")
SUPPORT_OPS = ("one_hot", "argsort", "huber_loss")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _unif(*shape, lo=0.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _boxes(n, lo=0.0, hi=1.0, min_wh=0.05, max_wh=0.4, seed=0):
    """n boxes x1 y1 x2 y2 inside [lo, hi]."""
    rng = np.random.default_rng(seed)
    span = hi - lo
    wh = rng.uniform(min_wh, max_wh, size=(n, 2)) * span
    xy = lo + rng.uniform(0, 1, size=(n, 2)) * (span - wh)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _ctx():
    return LowerContext(torch.device("cpu"), generator=torch.Generator())


def _jctx():
    return JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu")


def _run_both(op_type, ins, attrs):
    """({slot: [np]}, {slot: [np]}) of the port's and the JAX package's
    lowering on the same numpy inputs (both run op by op)."""
    got = pt_lowering(op_type)(
        _ctx(), {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
                 for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        _jctx(), {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    return ({k: [t.detach().numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()})


def _assert_same(a, w, what="", exact=False):
    """Same shape; the same dtype (int64 where jax gives int32); equal
    integers and bools, floats within FWD_TOL of the largest (equal bit
    for bit with `exact`)."""
    assert a.shape == w.shape, (what, a.shape, w.shape)
    assert a.dtype == w.dtype or (
        w.dtype == np.int32 and a.dtype == np.int64), (what, a.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating) and not exact:
        fin = np.isfinite(w)
        np.testing.assert_array_equal(fin, np.isfinite(a), err_msg=what)
        np.testing.assert_array_equal(a[~fin], w[~fin], err_msg=what)
        if fin.any():
            scale = max(float(np.abs(w[fin]).max()), 1e-30)
            assert float(np.abs(a[fin] - w[fin]).max()) <= FWD_TOL * scale, (
                what, float(np.abs(a[fin] - w[fin]).max()), scale)
    else:
        np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=what)


def _port_run(op_type, ins, attrs, wrt, out_slot, seed):
    """The port lowering's outputs and, with `wrt`, the gradient of
    out_slot in the wrt slots' inputs under a random cotangent (returned
    too)."""
    pt = {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
          for k, v in ins.items()}
    for s in wrt:
        pt[s] = [t.requires_grad_() for t in pt[s]]
    outs = pt_lowering(op_type)(_ctx(), pt, dict(attrs))
    cot, grads = None, []
    if wrt:
        y = outs[out_slot][0]
        cot = _rand(*y.shape, seed=seed)
        grads = torch.autograd.grad(y, [t for s in wrt for t in pt[s]],
                                    torch.from_numpy(cot))
    return ({k: [t.detach().numpy() for t in v] for k, v in outs.items()},
            [g.numpy() for g in grads], cot)


def _jax_run(op_type, ins, attrs, wrt, out_slot, cot, eager):
    """The same of the JAX lowering, the gradient by jax.vjp: one jitted
    function of every input (one XLA compile, much faster than the
    op-by-op dispatch for these lowerings), or op by op with `eager`, as
    the bit-exact checks need."""
    counts = [len(ins[s]) for s in wrt]

    def lower(args):
        return jax_lowering(op_type)(_jctx(), args, dict(attrs))

    def run(cot, args):
        outs = lower(args)
        if not wrt:
            return outs, []

        def f(*vals):
            a, it = dict(args), iter(vals)
            for s, n in zip(wrt, counts):
                a[s] = [next(it) for _ in range(n)]
            return lower(a)[out_slot][0]

        _, vjp = jax.vjp(f, *[v for s in wrt for v in args[s]])
        return outs, list(vjp(cot))

    outs, grads = (run if eager else jax.jit(run))(
        None if cot is None else jnp.asarray(cot),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()})
    return ({k: [np.asarray(x) for x in v] for k, v in outs.items()},
            [np.asarray(g) for g in grads])


def check(op_type, ins, attrs, wrt=(), out_slot=None, exact=False, seed=5):
    """The port's lowering against the JAX lowering: every output by
    _assert_same, and with `wrt` the gradients of out_slot in those
    inputs within GRAD_TOL of the largest JAX gradient."""
    got, ggot, cot = _port_run(op_type, ins, attrs, wrt, out_slot, seed)
    want, gwant = _jax_run(op_type, ins, attrs, wrt, out_slot, cot, exact)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for a, w in zip(got[slot], want[slot]):
            _assert_same(a, w, "%s.%s" % (op_type, slot), exact=exact)
    assert len(ggot) == len(gwant) == sum(len(ins[s]) for s in wrt)
    for i, (a, w) in enumerate(zip(ggot, gwant)):
        assert a.shape == w.shape, (op_type, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(a - w).max()) <= GRAD_TOL * scale, (op_type, i)


def test_every_new_op_has_a_port_lowering():
    from paddle_tpu_torch.ops import LOWERINGS

    for op in DETECTION_OPS + RCNN_OPS + SUPPORT_OPS:
        pt_lowering(op)
    assert len(LOWERINGS) == 324


def _feat(seed=0):
    return _rand(2, 3, 12, 12, seed=seed)


ROIS = np.array([[1.0, 2.0, 9.5, 8.0], [0.0, 0.0, 23.0, 23.0],
                 [5.2, 4.4, 6.1, 5.0], [10.0, 3.0, 20.5, 21.7],
                 [3.3, 12.1, 15.9, 19.4]], np.float32)
ROI_IDX = np.array([0, 1, 1, 0, 1], np.int32)
PIX_BOXES = np.array([[10, 10, 60, 50], [20, 15, 70, 65], [0, 0, 30, 28],
                      [55, 40, 95, 90], [12, 8, 58, 52]], np.float32)


def _deform_ins(mask=True, ho=7, cg=2):
    ins = {"Input": [_rand(2, 4, 7, 7)],
           "Offset": [0.7 * _rand(2, 2 * 2 * 9, ho, ho, seed=1)],
           "Filter": [_rand(6, cg, 3, 3, seed=2)]}
    if mask:
        ins["Mask"] = [_unif(2, 2 * 9, ho, ho, seed=3)]
    return ins


def _nms_ins(tied=False):
    boxes = np.stack([_boxes(20, seed=1), _boxes(20, seed=2)])
    scores = _unif(2, 4, 20, seed=3)
    if tied:
        scores = np.round(scores * 4) / 4      # many exact ties
        boxes[:, 5:10] = boxes[:, 0:5]         # identical boxes too
    return {"BBoxes": [boxes], "Scores": [scores]}


NMS_ATTRS = {"score_threshold": 0.1, "nms_top_k": 8, "keep_top_k": 10,
             "nms_threshold": 0.3, "background_label": 0}


def _yolo_gt():
    box = np.zeros((2, 3, 4), np.float32)
    box[0, 0] = [0.3, 0.4, 0.2, 0.3]
    box[0, 1] = [0.8, 0.2, 0.5, 0.1]
    box[1, 0] = [0.55, 0.6, 0.05, 0.08]
    label = np.array([[1, 2, 0], [0, 0, 0]], np.int32)
    return box, label


def _anchors_30():
    ys, xs = np.meshgrid(np.arange(5) * 20.0, np.arange(6) * 16.0,
                         indexing="ij")
    a = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 30.0,
                  ys.ravel() + 26.0], axis=1)
    return a.astype(np.float32)


GT_PIX = np.array([[[5, 5, 40, 35], [50, 30, 95, 80], [0, 0, 0, 0]],
                   [[20, 10, 60, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                  np.float32)
IM_INFO = np.array([[100, 110, 1.0], [90, 100, 1.0]], np.float32)


def _gp_ins():
    rng = np.random.default_rng(4)
    a, h, w = 3, 4, 5
    anchors = np.zeros((h, w, a, 4), np.float32)
    for i in range(h):
        for j in range(w):
            for k, s in enumerate((16, 24, 40)):
                cx, cy = j * 16 + 8, i * 16 + 8
                anchors[i, j, k] = [cx - s / 2, cy - s / 2, cx + s / 2,
                                    cy + s / 2]
    return {"Scores": [rng.uniform(0, 1, (2, a, h, w)).astype(np.float32)],
            "BboxDeltas": [(0.3 * rng.normal(size=(2, a * 4, h, w))).astype(
                np.float32)],
            "ImInfo": [np.array([[64, 80, 1.0], [60, 70, 2.0]], np.float32)],
            "Anchors": [anchors],
            "Variances": [np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                                  (h, w, a, 1))]}


def _retina_ins():
    rng = np.random.default_rng(6)
    ins = {"BBoxes": [], "Scores": [], "Anchors": []}
    for m, s in ((12, 0), (6, 1)):
        ins["BBoxes"].append((0.2 * rng.normal(size=(2, m, 4))).astype(
            np.float32))
        ins["Scores"].append(rng.uniform(0, 1, (2, m, 3)).astype(np.float32))
        ins["Anchors"].append(_boxes(m, 0, 90, 0.1, 0.4, seed=10 + s) )
    ins["ImInfo"] = [np.array([[90, 100, 1.0], [80, 90, 1.0]], np.float32)]
    return ins


def _lanms_ins():
    b = np.zeros((2, 8, 4), np.float32)
    for i in range(8):
        x = 0.1 * i
        b[:, i] = [x, 0.1, x + 0.15, 0.3]
    b[1, 4:] += 0.02
    return {"BBoxes": [b], "Scores": [_unif(2, 2, 8, lo=0.0, hi=1.0, seed=7)]}


def _mask_ins():
    segms = np.zeros((1, 2, 6, 2), np.float32)
    segms[0, 0, :4] = [[10, 10], [40, 12], [38, 44], [12, 40]]
    segms[0, 1, :3] = [[50, 50], [90, 55], [60, 90]]
    return {"GtClasses": [np.array([[1, 2]], np.int32)],
            "IsCrowd": [np.zeros((1, 2), np.int32)],
            "GtSegms": [segms],
            "GtSegmLens": [np.array([[4, 3]], np.int32)],
            "Rois": [np.array([[[8, 8, 42, 46], [48, 48, 92, 92],
                                [0, 0, 20, 20], [30, 30, 70, 70]]],
                              np.float32)],
            "LabelsInt32": [np.array([[1, 2, 0, 1]], np.int32)]}


QUADS = np.array([[1, 1, 8, 1, 8, 6, 1, 6],
                  [2, 1, 9, 2, 10, 8, 0.5, 7],
                  [3.5, 0.5, 7, 3, 5, 9, 1, 5]], np.float32)


def _dmap_ins():
    det = np.full((2, 5, 6), -1.0, np.float32)
    det[0, :4] = [[1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.5, 0.5, 0.9, 0.9],
                  [2, 0.7, 0.1, 0.5, 0.3, 0.8], [1, 0.3, 0.12, 0.1, 0.4, 0.42]]
    det[1, :3] = [[2, 0.95, 0.2, 0.2, 0.6, 0.6], [1, 0.6, 0.0, 0.0, 0.2, 0.2],
                  [2, 0.5, 0.6, 0.6, 0.9, 0.9]]
    gt = np.full((2, 3, 6), -1.0, np.float32)
    gt[0, :3] = [[1, 0.1, 0.1, 0.4, 0.4, 0], [1, 0.52, 0.5, 0.9, 0.88, 1],
                 [2, 0.1, 0.5, 0.3, 0.8, 0]]
    gt[1, :2] = [[2, 0.2, 0.2, 0.6, 0.6, 0], [2, 0.6, 0.6, 0.9, 0.9, 0]]
    return {"DetectRes": [det], "Label": [gt]}


def _case(name):
    """(op, ins, attrs, differentiable input slots, output slot, exact)."""
    x = _feat()
    rois = {"X": [x], "ROIs": [ROIS], "RoisBatchIdx": [ROI_IDX]}
    feat = {"Input": [np.zeros((1, 8, 5, 6), np.float32)],
            "Image": [np.zeros((1, 3, 300, 280), np.float32)]}
    return {
        "one_hot": ("one_hot", {"X": [np.array([[0], [4], [-1], [7], [2], [4]],
                                              np.int64)]},
                    {"depth": 5}, [], "Out", False),
        "one_hot_keep_dim": ("one_hot", {"X": [np.array([[1], [5]],
                                                        np.int64)]},
                             {"depth": 6, "_squeeze": False}, [], "Out",
                             False),
        "argsort": ("argsort", {"X": [np.array(
            [[0.0, -0.0, 1.5, 1.5, -2.0, 0.0, 1.5],
             [3.0, -0.0, -0.0, 0.0, 3.0, -1.0, 2.0]], np.float32)]},
            {"axis": -1, "descending": False}, ["X"], "Out", False),
        "argsort_desc": ("argsort", {"X": [np.array(
            [[0.0, -0.0, 1.5, 1.5, -2.0, 0.0, 1.5],
             [3.0, -0.0, -0.0, 0.0, 3.0, -1.0, 2.0]], np.float32)]},
            {"axis": -1, "descending": True}, ["X"], "Out", False),
        "argsort_axis0": ("argsort", {"X": [np.round(_rand(6, 3) * 2)]},
                          {"axis": 0, "descending": True}, ["X"], "Out",
                          False),
        "huber": ("huber_loss",
                  {"X": [np.array([0.5, -1.0, 2.0, 0.25, 3.0, -2.5],
                                  np.float32)],
                   "Y": [np.array([1.5, 0.0, 0.5, 0.0, -1.0, -2.0],
                                  np.float32)]},
                  {"delta": 1.0}, ["X", "Y"], "Out", False),
        "roi_pool": ("roi_pool", rois,
                     {"pooled_height": 2, "pooled_width": 3,
                      "spatial_scale": 0.5}, ["X"], "Out", False),
        "roi_align": ("roi_align", rois,
                      {"pooled_height": 2, "pooled_width": 3,
                       "spatial_scale": 0.5}, ["X", "ROIs"], "Out", False),
        "roi_align_ratio1": ("roi_align", {"X": [x], "ROIs": [ROIS]},
                             {"pooled_height": 3, "pooled_width": 2,
                              "spatial_scale": 0.4, "sampling_ratio": 1},
                             ["X", "ROIs"], "Out", False),
        "psroi_pool": ("psroi_pool",
                       {"X": [_rand(2, 12, 10, 10)], "ROIs": [ROIS],
                        "RoisBatchIdx": [ROI_IDX]},
                       {"output_channels": 2, "pooled_height": 2,
                        "pooled_width": 3, "spatial_scale": 0.4}, ["X"],
                       "Out", False),
        "prroi_pool": ("prroi_pool", rois,
                       {"pooled_height": 2, "pooled_width": 2,
                        "spatial_scale": 0.5}, ["X", "ROIs"], "Out", False),
        "deformable_conv": ("deformable_conv", _deform_ins(),
                            {"strides": [1, 1], "paddings": [1, 1],
                             "dilations": [1, 1], "groups": 2,
                             "deformable_groups": 2},
                            ["Input", "Offset", "Filter", "Mask"], "Output",
                            False),
        "deformable_conv_v1": ("deformable_conv", _deform_ins(mask=False, ho=4, cg=4),
                               {"strides": [2, 2], "paddings": [1, 1],
                                "dilations": [1, 1], "groups": 1,
                                "deformable_groups": 2},
                               ["Input", "Offset", "Filter"], "Output",
                               False),
        "box_encode": ("box_coder",
                       {"PriorBox": [_boxes(6, seed=1)],
                        "PriorBoxVar": [np.tile(np.array(
                            [0.1, 0.1, 0.2, 0.2], np.float32), (6, 1))],
                        "TargetBox": [_boxes(4, seed=2)]},
                       {"code_type": "encode_center_size"}, ["TargetBox"],
                       "OutputBox", False),
        "box_encode_pixels": ("box_coder",
                              {"PriorBox": [PIX_BOXES],
                               "TargetBox": [PIX_BOXES[::-1].copy()]},
                              {"code_type": "encode_center_size",
                               "box_normalized": False},
                              ["PriorBox", "TargetBox"], "OutputBox", False),
        "box_decode": ("box_coder",
                       {"PriorBox": [_boxes(6, seed=1)],
                        "PriorBoxVar": [np.tile(np.array(
                            [0.1, 0.1, 0.2, 0.2], np.float32), (6, 1))],
                        "TargetBox": [_rand(3, 6, 4, seed=3)]},
                       {"code_type": "decode_center_size"}, ["TargetBox"],
                       "OutputBox", False),
        "box_decode_2d": ("box_coder",
                          {"PriorBox": [_boxes(6, seed=1)],
                           "TargetBox": [_rand(6, 4, seed=4)]},
                          {"code_type": "decode_center_size"},
                          ["TargetBox", "PriorBox"], "OutputBox", False),
        "iou": ("iou_similarity", {"X": [_boxes(5, seed=1)],
                                   "Y": [_boxes(7, seed=2)]}, {}, ["X", "Y"],
                "Out", False),
        "prior_box": ("prior_box", feat,
                      {"min_sizes": [30.0, 60.0], "max_sizes": [60.0, 111.0],
                       "aspect_ratios": [1.0, 2.0, 3.0], "flip": True,
                       "variances": [0.1, 0.1, 0.2, 0.2]}, [], "Boxes",
                      True),
        "prior_box_clip_steps": ("prior_box", feat,
                                 {"min_sizes": [45.0],
                                  "aspect_ratios": [2.0], "flip": False,
                                  "clip": True, "step_w": 56.0,
                                  "step_h": 60.0, "offset": 0.3}, [],
                                 "Boxes", True),
        "density_prior_box": ("density_prior_box", feat,
                              {"densities": [2, 1],
                               "fixed_sizes": [30.0, 60.0],
                               "fixed_ratios": [1.0, 2.0], "clip": True},
                              [], "Boxes", True),
        "density_prior_box_flat": ("density_prior_box", feat,
                                   {"densities": [3], "fixed_sizes": [20.0],
                                    "flatten_to_2d": True}, [], "Boxes",
                                   True),
        "yolo_box": ("yolo_box",
                     {"X": [_rand(2, 16, 4, 5)],
                      "ImgSize": [np.array([[64, 80], [48, 60]], np.int32)]},
                     {"anchors": [10, 13, 16, 30], "class_num": 3,
                      "conf_thresh": 0.4, "downsample_ratio": 8}, ["X"],
                     "Boxes", False),
        "yolo_box_scores": ("yolo_box",
                            {"X": [_rand(2, 16, 4, 5)],
                             "ImgSize": [np.array([[64, 80], [48, 60]],
                                                  np.int32)]},
                            {"anchors": [10, 13, 16, 30], "class_num": 3,
                             "conf_thresh": 0.4, "downsample_ratio": 8},
                            ["X"], "Scores", False),
        "box_clip": ("box_clip",
                     {"Input": [np.stack([PIX_BOXES, PIX_BOXES + 20])],
                      "ImInfo": [np.array([[60, 80, 1.0], [100, 90, 2.0]],
                                          np.float32)]}, {}, ["Input"],
                     "Output", False),
        "box_clip_2d": ("box_clip",
                        {"Input": [PIX_BOXES],
                         "ImInfo": [np.array([60, 80, 1.0], np.float32)]},
                        {}, ["Input"], "Output", False),
        "nms": ("multiclass_nms", _nms_ins(), NMS_ATTRS, [], "Out", False),
        "nms_tied": ("multiclass_nms", _nms_ins(tied=True), NMS_ATTRS, [],
                     "Out", False),
        "nms_all": ("multiclass_nms", _nms_ins(),
                    dict(NMS_ATTRS, nms_top_k=-1, keep_top_k=30,
                         background_label=-1), [], "Out", False),
        "nms_adaptive": ("multiclass_nms", _nms_ins(),
                         dict(NMS_ATTRS, nms_eta=0.9, nms_threshold=0.6), [],
                         "Out", False),
        "nms_adaptive_tied": ("multiclass_nms", _nms_ins(tied=True),
                              dict(NMS_ATTRS, nms_eta=0.7,
                                   nms_threshold=0.8), [], "Out", False),
        "bipartite": ("bipartite_match", {"DistMat": [_unif(4, 7, seed=2)]},
                      {}, [], "ColToRowMatchIndices", False),
        "bipartite_tall": ("bipartite_match",
                           {"DistMat": [_unif(6, 3, seed=3)]}, {}, [],
                           "ColToRowMatchIndices", False),
        "bipartite_tied": ("bipartite_match", {"DistMat": [np.array(
            [[0.5, 0.5, 0.2, 0.5], [0.5, 0.5, 0.5, 0.1],
             [0.0, 0.5, 0.5, 0.5]], np.float32)]}, {}, [],
            "ColToRowMatchIndices", False),
        "yolov3_loss": ("yolov3_loss",
                        {"X": [_rand(2, 16, 4, 4)], "GTBox": [_yolo_gt()[0]],
                         "GTLabel": [_yolo_gt()[1]]},
                        {"anchors": [10, 13, 16, 30, 33, 23],
                         "anchor_mask": [0, 1], "class_num": 3,
                         "ignore_thresh": 0.5, "downsample_ratio": 8},
                        ["X"], "Loss", False),
        "anchor_generator": ("anchor_generator",
                             {"Input": [np.zeros((1, 8, 3, 4), np.float32)]},
                             {"anchor_sizes": [32.0, 64.0],
                              "aspect_ratios": [0.5, 1.0, 2.0],
                              "stride": [16.0, 16.0]}, [], "Anchors", False),
        "focal_loss": ("sigmoid_focal_loss",
                       {"X": [_rand(6, 3)],
                        "Label": [np.array([[1], [0], [3], [-1], [2], [1]],
                                           np.int32)],
                        "FgNum": [np.array([2], np.int32)]},
                       {"gamma": 2.0, "alpha": 0.25}, ["X"], "Out", False),
        "polygon": ("polygon_box_transform", {"Input": [_rand(2, 8, 3, 4)]},
                    {}, ["Input"], "Output", False),
        "decode_assign": ("box_decoder_and_assign",
                          {"PriorBox": [PIX_BOXES],
                           "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2],
                                                    np.float32)],
                           "TargetBox": [_rand(5, 12, seed=3)],
                           "BoxScore": [_unif(5, 3, seed=4)]},
                          {"box_clip": 4.135}, ["TargetBox"],
                          "OutputAssignBox", False),
        "target_assign": ("target_assign",
                          {"X": [_rand(2, 3, 4)],
                           "MatchIndices": [np.array(
                               [[1, -1, 0, 2, -1], [2, 2, -1, 0, 1]],
                               np.int32)],
                           "NegIndices": [np.array(
                               [[-1, 0, -1, -1, 3], [-1, -1, 1, -1, -1]],
                               np.int32)]},
                          {"mismatch_value": 7.0}, ["X"], "Out", False),
        "rpn_target_assign": ("rpn_target_assign",
                              {"Anchor": [_anchors_30()],
                               "GtBoxes": [GT_PIX],
                               "IsCrowd": [np.array([[0, 0, 0], [0, 1, 0]],
                                                    np.int32)],
                               "ImInfo": [IM_INFO],
                               "AnchorVar": [np.tile(np.array(
                                   [0.1, 0.1, 0.2, 0.2], np.float32),
                                   (30, 1))]},
                              {"rpn_batch_size_per_im": 12,
                               "rpn_fg_fraction": 0.25,
                               "rpn_positive_overlap": 0.5,
                               "rpn_negative_overlap": 0.2}, [],
                              "ScoreTarget", False),
        "retinanet_target_assign": ("retinanet_target_assign",
                                    {"Anchor": [_anchors_30()],
                                     "GtBoxes": [GT_PIX],
                                     "GtLabels": [np.array(
                                         [[1, 3, 0], [2, 0, 0]], np.int32)],
                                     "IsCrowd": [np.zeros((2, 3), np.int32)],
                                     "ImInfo": [IM_INFO]},
                                    {"positive_overlap": 0.4,
                                     "negative_overlap": 0.3}, [],
                                    "ScoreTarget", False),
        "generate_proposals": ("generate_proposals", _gp_ins(),
                               {"pre_nms_topN": 30, "post_nms_topN": 12,
                                "nms_thresh": 0.5, "min_size": 2.0}, [],
                               "RpnRois", False),
        "retinanet_output": ("retinanet_detection_output", _retina_ins(),
                             {"score_threshold": 0.2, "nms_top_k": 10,
                              "keep_top_k": 8, "nms_threshold": 0.4}, [],
                             "Out", False),
        "locality_aware_nms": ("locality_aware_nms", _lanms_ins(),
                               {"score_threshold": 0.2, "nms_top_k": -1,
                                "keep_top_k": 6, "nms_threshold": 0.3,
                                "background_label": -1}, [], "Out", False),
        "locality_aware_nms_pixels": ("locality_aware_nms", _lanms_ins(),
                                      {"score_threshold": 0.1,
                                       "nms_top_k": 5, "keep_top_k": 6,
                                       "nms_threshold": 0.2,
                                       "normalized": False, "nms_eta": 0.8,
                                       "background_label": 0}, [], "Out",
                                      False),
        "proposal_labels": ("generate_proposal_labels",
                            {"RpnRois": [np.stack([
                                _boxes(10, 0, 100, seed=5),
                                _boxes(10, 0, 100, seed=6)])],
                             "GtClasses": [np.array([[1, 2, 0], [3, 0, 0]],
                                                    np.int32)],
                             "IsCrowd": [np.array([[0, 1, 0], [0, 0, 0]],
                                                  np.int32)],
                             "GtBoxes": [GT_PIX], "ImInfo": [IM_INFO]},
                            {"batch_size_per_im": 8, "fg_fraction": 0.5,
                             "fg_thresh": 0.3, "bg_thresh_hi": 0.3},
                            [], "LabelsInt32", False),
        "mask_labels": ("generate_mask_labels", _mask_ins(),
                        {"num_classes": 3, "resolution": 7}, [], "MaskInt32",
                        False),
        "perspective": ("roi_perspective_transform",
                        {"X": [_rand(2, 3, 10, 12)], "ROIs": [QUADS],
                         "RoisBatchIdx": [np.array([0, 1, 1], np.int32)]},
                        {"transformed_height": 4, "transformed_width": 5,
                         "spatial_scale": 1.0}, ["X", "ROIs"], "Out",
                        False),
        "detection_map": ("detection_map", _dmap_ins(),
                          {"class_num": 3, "overlap_threshold": 0.5}, [],
                          "MAP", False),
        "detection_map_11point": ("detection_map", _dmap_ins(),
                                  {"class_num": 3, "overlap_threshold": 0.4,
                                   "ap_type": "11point",
                                   "evaluate_difficult": False}, [], "MAP",
                                  False),
    }[name]


DETECTION_CASES = (
    "one_hot", "one_hot_keep_dim", "argsort", "argsort_desc",
    "argsort_axis0", "huber", "roi_pool", "roi_align", "roi_align_ratio1",
    "psroi_pool", "prroi_pool", "deformable_conv", "deformable_conv_v1",
    "box_encode", "box_encode_pixels", "box_decode", "box_decode_2d", "iou",
    "prior_box", "prior_box_clip_steps", "density_prior_box",
    "density_prior_box_flat", "yolo_box", "yolo_box_scores", "box_clip",
    "box_clip_2d", "nms", "nms_tied", "nms_all", "nms_adaptive",
    "nms_adaptive_tied", "bipartite", "bipartite_tall", "bipartite_tied",
    "yolov3_loss")
RCNN_CASES = (
    "anchor_generator", "focal_loss", "polygon", "decode_assign",
    "target_assign", "rpn_target_assign", "retinanet_target_assign",
    "generate_proposals", "retinanet_output", "locality_aware_nms",
    "locality_aware_nms_pixels", "proposal_labels", "mask_labels",
    "perspective", "detection_map", "detection_map_11point")


def check_case(case):
    check(*_case(case))


@pytest.mark.parametrize("case", DETECTION_CASES)
def test_lowering_matches_jax(case):
    check_case(case)


def test_every_op_is_covered():
    covered = {_case(c)[0] for c in DETECTION_CASES + RCNN_CASES}
    assert covered == set(DETECTION_OPS + RCNN_OPS + SUPPORT_OPS)


def test_argsort_ties_and_signed_zeros_keep_index_order():
    """Equal keys, +0.0 and -0.0 among them, come out in ascending index
    order in both directions (descending sorts -X stably)."""
    x = np.array([[0.0, -0.0, 1.5, 1.5, -2.0, 0.0]], np.float32)
    got, _ = _run_both("argsort", {"X": [x]}, {"descending": False})
    np.testing.assert_array_equal(got["Indices"][0], [[4, 0, 1, 5, 2, 3]])
    got, _ = _run_both("argsort", {"X": [x]}, {"descending": True})
    np.testing.assert_array_equal(got["Indices"][0], [[2, 3, 0, 1, 5, 4]])
    assert np.signbit(got["Out"][0][0, 3])      # Out keeps X's own -0.0


def test_one_hot_out_of_range_ids_give_zero_rows():
    ids = np.array([[3], [-1], [5], [9]], np.int64)
    got, want = _run_both("one_hot", {"X": [ids]}, {"depth": 5})
    out = got["Out"][0]
    np.testing.assert_array_equal(out, np.asarray(want["Out"][0]))
    np.testing.assert_array_equal(out.sum(axis=1), [1, 0, 0, 0])


def test_nms_and_bipartite_ties_take_the_first_index():
    """Equal scores: NMS keeps the lowest flat (class, box) index first;
    bipartite_match takes the first maximum in row-major order."""
    boxes = np.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.7, 0.7],
                       [0.0, 0.0, 0.2, 0.2]]], np.float32)
    scores = np.full((1, 2, 3), 0.5, np.float32)
    got, _ = _run_both("multiclass_nms", {"BBoxes": [boxes],
                                          "Scores": [scores]},
                       {"score_threshold": 0.1, "keep_top_k": 3,
                        "nms_threshold": 0.5, "background_label": -1})
    np.testing.assert_array_equal(got["Index"][0][0, :, 0], [0, 1, 0])
    np.testing.assert_array_equal(got["Out"][0][0, :, 0], [0, 0, 1])
    dist = np.array([[0.5, 0.9, 0.9], [0.9, 0.9, 0.1]], np.float32)
    got, _ = _run_both("bipartite_match", {"DistMat": [dist]}, {})
    np.testing.assert_array_equal(got["ColToRowMatchIndices"][0],
                                  [[1, 0, -1]])


def _all_layers(fl):
    """Every detection layer and the ROI layers of layers/nn.py once."""
    L = fl.layers
    D = L.detection
    img = fl.data("img", [2, 3, 32, 32], "float32")
    f1 = L.conv2d(img, 8, 3, stride=4, padding=1)          # (2, 8, 8, 8)
    f2 = L.conv2d(f1, 8, 3, stride=2, padding=1)           # (2, 8, 4, 4)
    locs, confs, pbox, pvar = D.multi_box_head(
        [f1, f2], img, 32, 3, [[1.0, 2.0], [1.0]], min_ratio=20,
        max_ratio=90)
    gt = fl.data("gt", [4, 4], "float32")
    gl = fl.data("gl", [4, 1], "int64")
    n_prior = pbox.shape[0]
    loss = D.ssd_loss(L.reshape(L.slice(locs, [0], [0], [1]), [-1, 4]),
                      L.reshape(L.slice(confs, [0], [0], [1]), [-1, 3]),
                      gt, gl, pbox, pvar)
    iou = D.iou_similarity(gt, pbox)
    D.bipartite_match(iou)
    D.box_coder(pbox, pvar, gt)
    D.density_prior_box(f2, img, densities=[2], fixed_sizes=[8.0],
                        fixed_ratios=[1.0], flatten_to_2d=True)
    det = D.detection_output(L.reshape(L.slice(locs, [0], [0], [1]),
                                       [-1, 4]),
                             L.transpose(L.softmax(confs), [0, 2, 1]),
                             pbox, pvar, keep_top_k=5)
    lbl = fl.data("lbl", [2, 4, 6], "float32")
    D.detection_map(det, lbl, 3)
    boxes = fl.data("boxes", [2, 6, 4], "float32")
    scores = fl.data("scores", [2, 3, 6], "float32")
    D.multiclass_nms(boxes, scores, 0.1, 4, 5, nms_eta=0.9)
    D.locality_aware_nms(boxes, scores, 0.1, 4, 5)
    im = fl.data("im", [2, 3], "float32")
    D.box_clip(boxes, im)
    yx = fl.data("yx", [2, 16, 4, 4], "float32")
    ysz = fl.data("ysz", [2, 2], "int32")
    D.yolo_box(yx, ysz, [10, 13, 16, 30], 3, 0.01, 8)
    D.yolov3_loss(yx, fl.data("yb", [2, 3, 4], "float32"),
                  fl.data("yl", [2, 3], "int32"), [10, 13, 16, 30], [0, 1],
                  3, 0.5, 8)
    anc, avar = D.anchor_generator(f2, [16.0, 32.0], [0.5, 1.0],
                                   stride=[8.0, 8.0])
    gtb = fl.data("gtb", [2, 3, 4], "float32")
    crowd = fl.data("crowd", [2, 3], "int32")
    gcls = fl.data("gcls", [2, 3], "int32")
    bp = fl.data("bp", [2, 64, 4], "float32")
    cl = fl.data("cl", [2, 64, 1], "float32")
    D.rpn_target_assign(bp, cl, anc, avar, gtb, crowd, im,
                        rpn_batch_size_per_im=16)
    _, _, st, _, _, fgn = D.retinanet_target_assign(
        bp, cl, anc, avar, gtb, gcls, crowd, im, num_classes=3)
    D.sigmoid_focal_loss(fl.data("fx", [8, 3], "float32"),
                         fl.data("flab", [8, 1], "int32"),
                         fl.data("fgn", [1], "int32"))
    rois, probs = D.generate_proposals(
        fl.data("rs", [2, 4, 4, 4], "float32"),
        fl.data("rd", [2, 16, 4, 4], "float32"), im, anc, avar,
        pre_nms_top_n=20, post_nms_top_n=6)
    D.target_assign(gtb, fl.data("mi", [2, 5], "int32"),
                    negative_indices=fl.data("ni", [2, 5], "int32"))
    D.polygon_box_transform(fl.data("geo", [2, 8, 4, 4], "float32"))
    D.box_decoder_and_assign(fl.data("pb", [5, 4], "float32"),
                             fl.data("pbv", [4], "float32"),
                             fl.data("tb", [5, 12], "float32"),
                             fl.data("bs", [5, 3], "float32"), 4.135)
    D.retinanet_detection_output([bp], [fl.data("rsc", [2, 64, 3],
                                                "float32")],
                                 [anc], im, keep_top_k=5)
    flat = fl.data("flat", [6, 4], "float32")
    outs, restore = D.distribute_fpn_proposals(flat, 2, 4, 3, 64)
    D.collect_fpn_proposals(outs, [fl.data("fs%d" % i, [6, 1], "float32")
                                   for i in range(3)], 2, 4, 4)
    lab2, _, _, _, _ = D.generate_proposal_labels(rois, gcls, crowd, gtb, im,
                                                  batch_size_per_im=8)[:5]
    D.generate_mask_labels(im, gcls, crowd,
                           fl.data("segs", [2, 3, 5, 2], "float32"), rois,
                           fl.data("rl", [2, 6], "int32"), 3, 7,
                           gt_segm_lens=fl.data("segl", [2, 3], "int32"))
    roi = fl.data("roi", [3, 4], "float32")
    quad = fl.data("quad", [3, 8], "float32")
    D.roi_perspective_transform(f1, quad, 3, 4)
    L.roi_pool(f1, roi, 2, 2, 0.25)
    L.roi_align(f1, roi, 2, 2, 0.25)
    L.psroi_pool(f1, roi, 2, 0.25, 2, 2)
    L.prroi_pool(f1, roi, 0.25, 2, 2)
    L.deformable_conv(f1, fl.data("off", [2, 18, 8, 8], "float32"),
                      fl.data("msk", [2, 9, 8, 8], "float32"), 4, 3,
                      padding=1)
    L.one_hot(gl, 3)
    L.argsort(L.reshape(iou, [-1]), descending=True)
    L.huber_loss(flat, flat, 1.0)
    return loss


def test_every_detection_layer_builds_the_reference_s_program():
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            _all_layers(fl)
        progs.append((main, start))
    (jm, js), (pm, ps) = progs
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    from paddle_tpu_torch.fluid.layers import detection
    assert len(detection.__all__) == 28
    called = {op.type for op in pm.global_block().ops}
    assert set(DETECTION_OPS + RCNN_OPS + SUPPORT_OPS) <= called
