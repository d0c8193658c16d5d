"""The loss, math and metric op types of this slice, ``nce``,
``hierarchical_sigmoid`` and ``split``, and their layers, in the port
against the JAX package, on the CPU.

- 16 loss op types (``paddle_tpu/ops/loss_ops.py``), 10 math op types
  (``math_ops.py``), ``mean_iou`` and ``precision_recall``
  (``metric_ops.py``), ``nce`` and ``hierarchical_sigmoid``
  (``misc_ops.py``) and ``split`` (``tensor_ops.py``): each port lowering
  against the JAX lowering on the same seeded numpy inputs and attrs by
  tests/test_torch_activations.py's rule (outputs within 1e-6 of the
  largest value, integers and bools equal, gradients through
  torch.autograd within 1e-5 of jax.vjp's largest, NaN where jax.vjp
  gives NaN; one jitted JAX function a case).
- The cases sit on what the two packages could do differently: labels
  out of range and negative (``center_loss``'s gather clamps and its
  scatter-adds drop; ``mean_iou`` and ``precision_recall`` drop;
  ``bpr_loss``'s take_along_axis reads NaN; ``dice_loss``'s one-hot row
  is zero), tied minima and zeros in a product, zero rows in
  ``cos_sim`` and ``l2_normalize`` (sqrt(0)'s NaN gradient, as jax's),
  the kinks of ``hinge_loss``, ``margin_rank_loss``,
  ``smooth_l1_loss``, ``sigmoid_cross_entropy_with_logits`` and
  ``teacher_student_sigmoid_loss``, ``rank_loss``'s overflow to inf,
  int32 outputs where the reference declares them, bool reductions.
- ``nce`` and ``sampled_softmax_with_cross_entropy`` draw from the run's
  torch.Generator: the JAX lowering is handed the port's samples (its
  ``jax.random.randint`` monkeypatched in the test only). The draws are
  held by their support, uniformity and seeding, and both op types stay
  in ``fluid/lowering.py``'s DRAWS.
- ``npair_loss_helper`` raises in both packages; the ``npair_loss`` layer
  composes other ops.
- The layers build the same Program JSON in both packages, startup
  included, and run to the same values.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering_mod
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering
from test_torch_activations import FWD_TOL, assert_close, check
from test_torch_detection import _rand

LOSS_OPS = (
    "cross_entropy2", "sigmoid_cross_entropy_with_logits",
    "square_error_cost", "squared_l2_distance", "smooth_l1_loss",
    "hinge_loss", "margin_rank_loss", "rank_loss", "bpr_loss", "kldiv_loss",
    "dice_loss", "center_loss", "npair_loss_helper", "mse_loss",
    "sampled_softmax_with_cross_entropy", "teacher_student_sigmoid_loss")
MATH_OPS = ("reduce_min", "reduce_prod", "reduce_all", "reduce_any",
            "l2_normalize", "cos_sim", "bilinear_tensor_product",
            "frobenius_norm", "kron", "dot")
OTHER_OPS = ("nce", "hierarchical_sigmoid", "mean_iou", "precision_recall",
             "split")


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


def _ints(*shape, lo=0, hi=5, seed=0, dtype=np.int64):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        dtype)


def _unif(*shape, lo=0.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _probs(n, c, seed=0):
    e = np.exp(_rand(n, c, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _tied():
    x = _rand(3, 4, 5, seed=1)
    x[0, 1, :] = x[0, 0, :]          # ties along axis 1
    x[1, :, 2] = -3.0                # ties along the whole column
    return x


def _zeros_in_rows():
    x = _unif(3, 5, lo=0.5, hi=1.5, seed=2)
    x[0, 2] = 0.0                    # one zero in a row
    x[1, 1] = x[1, 3] = 0.0          # two zeros in a row
    return x


def _zero_row(x, row=1):
    x = np.array(x)
    x[row] = 0.0
    return x


BAD_LABELS = np.array([[1], [4], [-1], [7], [0], [-6]], np.int64)


def _case(name):
    """(op, ins, attrs, differentiable input slots, output slot)."""
    lab = _ints(6, 1, hi=5, seed=3)
    hinge_x = np.array([[1.0], [-1.0], [0.3], [2.0], [-0.2], [1.0]],
                       np.float32)
    hinge_l = np.array([[1.0], [0.0], [1.0], [0.0], [0.0], [0.0]],
                       np.float32)
    return {
        # math
        "reduce_min": ("reduce_min", {"X": [_tied()]},
                       {"dim": [1], "keep_dim": False}, ["X"], "Out"),
        "reduce_min_keep": ("reduce_min", {"X": [_tied()]},
                            {"dim": [0, 2], "keep_dim": True}, ["X"], "Out"),
        "reduce_min_all": ("reduce_min", {"X": [_tied()]},
                           {"dim": None, "reduce_all": True}, ["X"], "Out"),
        "reduce_prod": ("reduce_prod", {"X": [_zeros_in_rows()]},
                        {"dim": [1]}, ["X"], "Out"),
        "reduce_prod_keep": ("reduce_prod", {"X": [_zeros_in_rows()]},
                             {"dim": [-1], "keep_dim": True}, ["X"], "Out"),
        "reduce_prod_two_axes": ("reduce_prod",
                                 {"X": [_unif(2, 3, 4, lo=0.5, hi=1.5)]},
                                 {"dim": [0, 2]}, ["X"], "Out"),
        "reduce_prod_all": ("reduce_prod", {"X": [_zeros_in_rows()[2:]]},
                            {"dim": None, "reduce_all": True}, ["X"], "Out"),
        "reduce_all": ("reduce_all", {"X": [np.array(
            [[1.0, 0.0, 2.0], [3.0, 4.0, -1.0]], np.float32)]},
            {"dim": [1]}, [], "Out"),
        "reduce_all_bool": ("reduce_all", {"X": [np.array(
            [[True, True], [True, False]])]},
            {"dim": None, "reduce_all": True}, [], "Out"),
        "reduce_any": ("reduce_any", {"X": [np.array(
            [[0.0, 0.0, 2.0], [0.0, 0.0, 0.0]], np.float32)]},
            {"dim": [1], "keep_dim": True}, [], "Out"),
        "reduce_any_int": ("reduce_any", {"X": [np.array(
            [[0, 0], [0, 3]], np.int64)]}, {"dim": [0]}, [], "Out"),
        "l2_normalize": ("l2_normalize", {"X": [_rand(4, 6, seed=4)]},
                         {"axis": 1, "epsilon": 1e-12}, ["X"], "Out"),
        "l2_normalize_zero_row": ("l2_normalize",
                                  {"X": [_zero_row(_rand(4, 6, seed=4))]},
                                  {"axis": -1}, ["X"], "Out"),
        "l2_normalize_axis0": ("l2_normalize", {"X": [_rand(4, 6, seed=9)]},
                               {"axis": 0}, ["X"], "Out"),
        "cos_sim": ("cos_sim", {"X": [_rand(5, 7, seed=6)],
                                "Y": [_rand(5, 7, seed=7)]}, {},
                    ["X", "Y"], "Out"),
        "cos_sim_one_row": ("cos_sim", {"X": [_rand(5, 7, seed=6)],
                                        "Y": [_rand(1, 7, seed=8)]}, {},
                            ["X", "Y"], "Out"),
        "cos_sim_zero_row": ("cos_sim",
                             {"X": [_zero_row(_rand(5, 7, seed=6))],
                              "Y": [_rand(5, 7, seed=7)]}, {},
                             ["X", "Y"], "Out"),
        "bilinear": ("bilinear_tensor_product",
                     {"X": [_rand(4, 3, seed=9)], "Y": [_rand(4, 5, seed=10)],
                      "Weight": [_rand(6, 3, 5, seed=11)],
                      "Bias": [_rand(1, 6, seed=12)]}, {},
                     ["X", "Y", "Weight", "Bias"], "Out"),
        "bilinear_no_bias": ("bilinear_tensor_product",
                             {"X": [_rand(4, 3, seed=9)],
                              "Y": [_rand(4, 5, seed=10)],
                              "Weight": [_rand(2, 3, 5, seed=11)]}, {},
                             ["X", "Y", "Weight"], "Out"),
        "frobenius_norm": ("frobenius_norm", {"X": [_rand(3, 4, 2, seed=13)]},
                           {"dim": [1, 2]}, ["X"], "Out"),
        "kron": ("kron", {"X": [_rand(2, 3, seed=14)],
                          "Y": [_rand(3, 2, seed=15)]}, {}, ["X", "Y"],
                 "Out"),
        "kron_3d": ("kron", {"X": [_rand(2, 2, 2, seed=14)],
                             "Y": [_rand(1, 3, 2, seed=15)]}, {},
                    ["X", "Y"], "Out"),
        "dot": ("dot", {"X": [_rand(4, 5, seed=16)],
                        "Y": [_rand(4, 5, seed=17)]}, {}, ["X", "Y"], "Out"),
        "dot_1d": ("dot", {"X": [_rand(5, seed=16)], "Y": [_rand(5, seed=17)]},
                   {}, ["X", "Y"], "Out"),
        # losses
        "cross_entropy2": ("cross_entropy2",
                           {"X": [_probs(6, 5)],
                            "Label": [np.array([[1], [4], [-100], [0], [2],
                                                [3]], np.int64)]},
                           {"ignore_index": -100}, ["X"], "Y"),
        "sigmoid_ce": ("sigmoid_cross_entropy_with_logits",
                       {"X": [np.concatenate([np.zeros((1, 4), np.float32),
                                              _rand(3, 4, seed=18)])],
                        "Label": [np.where(_unif(4, 4, seed=19) < 0.2, -100.0,
                                           _unif(4, 4, seed=20)).astype(
                                               np.float32)]},
                       {"ignore_index": -100}, ["X"], "Out"),
        "sigmoid_ce_normalize": ("sigmoid_cross_entropy_with_logits",
                                 {"X": [_rand(4, 4, seed=18)],
                                  "Label": [np.where(
                                      _unif(4, 4, seed=19) < 0.3, -1.0,
                                      (_unif(4, 4, seed=20) > 0.5)).astype(
                                          np.float32)]},
                                 {"ignore_index": -1, "normalize": True},
                                 ["X"], "Out"),
        "square_error_cost": ("square_error_cost",
                              {"X": [_rand(6, 1, seed=21)],
                               "Y": [_rand(6, 1, seed=22)]}, {}, ["X", "Y"],
                              "Out"),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": [_rand(5, 4, seed=23)],
                                 "Y": [_rand(5, 4, seed=24)]}, {},
                                ["X", "Y"], "Out"),
        "squared_l2_distance_one_row": ("squared_l2_distance",
                                        {"X": [_rand(5, 4, seed=23)],
                                         "Y": [_rand(1, 4, seed=24)]}, {},
                                        ["X", "Y"], "Out"),
        "smooth_l1": ("smooth_l1_loss",
                      {"X": [np.array([[0.5, 2.0], [1.0, -3.0],
                                       [0.25, 0.0]], np.float32)],
                       "Y": [np.array([[0.0, 0.0], [0.0, 0.0],
                                       [0.0, 0.0]], np.float32)]},
                      {"sigma": 2.0}, ["X", "Y"], "Out"),
        "smooth_l1_weights": ("smooth_l1_loss",
                              {"X": [_rand(4, 3, 2, seed=25)],
                               "Y": [_rand(4, 3, 2, seed=26)],
                               "InsideWeight": [_unif(4, 3, 2, seed=27)],
                               "OutsideWeight": [_unif(4, 3, 2, seed=28)]},
                              {}, ["X", "Y"], "Out"),
        "hinge_loss": ("hinge_loss", {"Logits": [hinge_x],
                                      "Labels": [hinge_l]}, {}, ["Logits"],
                       "Loss"),
        "margin_rank_loss": ("margin_rank_loss",
                             {"Label": [np.array([[1.0], [-1.0], [1.0],
                                                  [-1.0]], np.float32)],
                              "X1": [np.array([[0.1], [0.5], [0.7], [0.0]],
                                              np.float32)],
                              "X2": [np.array([[0.2], [0.4], [0.1], [0.3]],
                                              np.float32)]},
                             {"margin": 0.1}, ["X1", "X2"], "Out"),
        "rank_loss": ("rank_loss",
                      {"Label": [_unif(5, 1, seed=29)],
                       "Left": [np.array([[0.3], [100.0], [-2.0], [0.0],
                                          [1.0]], np.float32)],
                       "Right": [np.array([[0.1], [0.0], [1.0], [0.0],
                                           [-1.5]], np.float32)]},
                      {}, [], "Out"),
        "rank_loss_grad": ("rank_loss",
                           {"Label": [_unif(5, 1, seed=29)],
                            "Left": [_rand(5, 1, seed=30)],
                            "Right": [_rand(5, 1, seed=31)]}, {},
                           ["Left", "Right"], "Out"),
        "bpr_loss": ("bpr_loss", {"X": [_rand(6, 5, seed=32)],
                                  "Label": [lab]}, {}, ["X"], "Y"),
        "bpr_loss_bad_labels": ("bpr_loss", {"X": [_rand(6, 5, seed=32)],
                                             "Label": [BAD_LABELS]}, {}, [],
                                "Y"),
        "kldiv_mean": ("kldiv_loss", {"X": [_rand(4, 5, seed=33)],
                                      "Target": [np.where(
                                          _unif(4, 5, seed=34) < 0.3, 0.0,
                                          _unif(4, 5, seed=35)).astype(
                                              np.float32)]},
                       {"reduction": "mean"}, ["X", "Target"], "Loss"),
        "kldiv_sum": ("kldiv_loss", {"X": [_rand(4, 5, seed=33)],
                                     "Target": [_unif(4, 5, seed=35)]},
                      {"reduction": "sum"}, ["X", "Target"], "Loss"),
        "kldiv_batchmean": ("kldiv_loss", {"X": [_rand(4, 5, seed=33)],
                                           "Target": [_unif(4, 5, seed=35)]},
                            {"reduction": "batchmean"}, ["X"], "Loss"),
        "kldiv_none": ("kldiv_loss", {"X": [_rand(4, 5, seed=33)],
                                      "Target": [np.where(
                                          _unif(4, 5, seed=34) < 0.3, 0.0,
                                          _unif(4, 5, seed=35)).astype(
                                              np.float32)]},
                       {"reduction": "none"}, ["X", "Target"], "Loss"),
        "dice_loss": ("dice_loss", {"X": [_probs(6, 5, seed=36)],
                                    "Label": [BAD_LABELS]},
                      {"epsilon": 1e-5}, ["X"], "Out"),
        "center_loss": ("center_loss",
                        {"X": [_rand(6, 3, seed=37)],
                         "Label": [BAD_LABELS],
                         "Centers": [_rand(5, 3, seed=38)],
                         "CenterUpdateRate": [np.array([0.3], np.float32)]},
                        {"need_update": True}, ["X"], "Loss"),
        "center_loss_centers": ("center_loss",
                                {"X": [_rand(6, 3, seed=37)],
                                 "Label": [BAD_LABELS],
                                 "Centers": [_rand(5, 3, seed=38)],
                                 "CenterUpdateRate": [np.array(
                                     [0.3], np.float32)]},
                                {"need_update": True}, ["X"], "CentersOut"),
        "center_loss_frozen": ("center_loss",
                               {"X": [_rand(6, 3, seed=37)], "Label": [lab],
                                "Centers": [_rand(5, 3, seed=38)]},
                               {"need_update": False}, ["X"], "Loss"),
        "mse_loss": ("mse_loss", {"X": [_rand(4, 3, seed=39)],
                                  "Y": [_rand(4, 3, seed=40)]}, {},
                     ["X", "Y"], "Out"),
        "teacher_student": ("teacher_student_sigmoid_loss",
                            {"X": [np.array([[15.0], [-15.0], [0.0], [20.0],
                                             [-0.7], [3.0]], np.float32)],
                             "Label": [_unif(6, 1, seed=41)]},
                            {"soft_max_up_bound": 15.0}, ["X"], "Y"),
        # misc, metric, split
        "hsigmoid": ("hierarchical_sigmoid",
                     {"X": [_rand(6, 4, seed=42)],
                      "Label": [np.array([[0], [5], [3], [1], [4], [2]],
                                         np.int64)],
                      "W": [_rand(5, 4, seed=43)],
                      "Bias": [_rand(5, 1, seed=44)]},
                     {"num_classes": 6}, ["X", "W", "Bias"], "Out"),
        "hsigmoid_pow2_no_bias": ("hierarchical_sigmoid",
                                  {"X": [_rand(5, 3, seed=45)],
                                   "Label": [np.array([0, 7, 3, 4, 6],
                                                      np.int64)],
                                   "W": [_rand(7, 3, seed=46)]},
                                  {"num_classes": 8}, ["X", "W"], "Out"),
        "mean_iou": ("mean_iou",
                     {"Predictions": [_ints(4, 5, hi=3, seed=47)],
                      "Labels": [_ints(4, 5, hi=3, seed=48)]},
                     {"num_classes": 3}, [], "OutMeanIou"),
        "mean_iou_bad_labels": ("mean_iou",
                                {"Predictions": [np.array(
                                    [2, 0, 1, 2, 2, 1, 0], np.int64)],
                                 "Labels": [np.array(
                                     [-1, 3, 1, 2, -4, 5, 0], np.int64)]},
                                {"num_classes": 3}, [], "OutMeanIou"),
        "precision_recall": ("precision_recall",
                             {"Indices": [_ints(8, 1, hi=4, seed=49)],
                              "Labels": [_ints(8, 1, hi=4, seed=50)]},
                             {"class_number": 4}, [], "BatchMetrics"),
        "precision_recall_bad_labels": ("precision_recall",
                                        {"Indices": [np.array(
                                            [[0], [1], [3], [2], [5]],
                                            np.int64)],
                                         "Labels": [np.array(
                                             [-1, 1, 4, 2, 0], np.int64)]},
                                        {"class_number": 4}, [],
                                        "BatchMetrics"),
        "split_num": ("split", {"X": [_rand(2, 6, 3, seed=51)]},
                      {"num": 3, "axis": 1}, ["X"], "Out"),
        "split_sections": ("split", {"X": [_rand(2, 6, 5, seed=52)]},
                           {"sections": [2, 1, 2], "axis": -1}, ["X"], "Out"),
    }[name]


CASES = (
    "reduce_min", "reduce_min_keep", "reduce_min_all", "reduce_prod",
    "reduce_prod_keep", "reduce_prod_two_axes", "reduce_prod_all",
    "reduce_all", "reduce_all_bool", "reduce_any", "reduce_any_int",
    "l2_normalize", "l2_normalize_zero_row", "l2_normalize_axis0", "cos_sim",
    "cos_sim_one_row", "cos_sim_zero_row", "bilinear", "bilinear_no_bias",
    "frobenius_norm", "kron", "kron_3d", "dot", "dot_1d", "cross_entropy2",
    "sigmoid_ce", "sigmoid_ce_normalize", "square_error_cost",
    "squared_l2_distance", "squared_l2_distance_one_row", "smooth_l1",
    "smooth_l1_weights", "hinge_loss", "margin_rank_loss", "rank_loss",
    "rank_loss_grad", "bpr_loss", "bpr_loss_bad_labels", "kldiv_mean",
    "kldiv_sum", "kldiv_batchmean", "kldiv_none", "dice_loss",
    "center_loss", "center_loss_centers", "center_loss_frozen", "mse_loss",
    "teacher_student", "hsigmoid", "hsigmoid_pow2_no_bias", "mean_iou",
    "mean_iou_bad_labels", "precision_recall",
    "precision_recall_bad_labels", "split_num", "split_sections")


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, out = _case(case)
    check(op, ins, attrs, wrt=tuple(wrt), out_slot=out)


def test_every_op_is_covered():
    covered = {_case(c)[0] for c in CASES} | {
        "nce", "sampled_softmax_with_cross_entropy", "npair_loss_helper"}
    assert covered == set(LOSS_OPS + MATH_OPS + OTHER_OPS)


def test_the_port_registers_232_op_types():
    from paddle_tpu_torch.ops import LOWERINGS

    for op in LOSS_OPS + MATH_OPS + OTHER_OPS:
        pt_lowering(op)
    assert len(LOWERINGS) == 324


def _run(op, ins, attrs):
    t = {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
         for k, v in ins.items()}
    return pt_lowering(op)(LowerContext(torch.device("cpu")), t, attrs)


def test_out_of_range_labels_follow_jax_s_index_rules():
    """center_loss: the gather clamps (7 reads row 4, -6 reads row 0 after
    one wrap to -1), the scatter-adds drop 7 and -6 and count -1 as row 4;
    mean_iou: a negative label·n + pred wraps once, the rest drop;
    bpr_loss: NaN rows for labels left out of range."""
    x, centers = _rand(6, 3, seed=37), _rand(5, 3, seed=38)
    out = _run("center_loss", {"X": [x], "Label": [BAD_LABELS],
                               "Centers": [centers],
                               "CenterUpdateRate": [np.array([1.0],
                                                             np.float32)]},
               {"need_update": True})
    picked = centers[[1, 4, 4, 4, 0, 0]]
    np.testing.assert_allclose(out["SampleCenterDiff"][0].numpy(),
                               x - picked, rtol=1e-6)
    moved = out["CentersOut"][0].numpy() - centers
    assert np.abs(moved[[2, 3]]).max() == 0.0      # no label there
    d = x - picked
    np.testing.assert_allclose(moved[4], (d[1] + d[2]) / 3.0, rtol=1e-5)
    np.testing.assert_allclose(moved[0], d[4] / 2.0, rtol=1e-5)
    miou = _run("mean_iou", {"Predictions": [np.array([2, 0, 1], np.int64)],
                             "Labels": [np.array([-1, 3, 1], np.int64)]},
                {"num_classes": 3})
    # (-1)·3 + 2 = -1 wraps to cell 8 = (2, 2); 3·3 + 0 = 9 is dropped
    np.testing.assert_array_equal(miou["OutCorrect"][0].numpy(), [0, 1, 1])
    assert miou["OutCorrect"][0].dtype == torch.int32
    assert miou["OutWrong"][0].dtype == torch.int32
    y = _run("bpr_loss", {"X": [_rand(6, 5, seed=32)],
                          "Label": [BAD_LABELS]}, {})["Y"][0].numpy()
    np.testing.assert_array_equal(np.isnan(y[:, 0]),
                                  [False, False, False, True, False, True])


def test_int32_and_bool_outputs():
    got = _run("reduce_any", {"X": [np.array([[0.0, 1.0]], np.float32)]},
               {"dim": [1]})["Out"][0]
    assert got.dtype == torch.bool
    got = _run("reduce_all", {"X": [np.array([[0.0, 1.0]], np.float32)]},
               {"dim": None, "reduce_all": True})["Out"][0]
    assert got.dtype == torch.bool and got.shape == ()


def test_rank_loss_overflows_as_the_reference_writes_it():
    """log1p(exp(d)) for d = 100: inf in both packages (not softplus)."""
    ins = {"Label": [np.array([[0.5]], np.float32)],
           "Left": [np.array([[100.0]], np.float32)],
           "Right": [np.array([[0.0]], np.float32)]}
    assert np.isinf(_run("rank_loss", ins, {})["Out"][0].numpy()).all()
    want = jax_lowering("rank_loss")(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, {})
    assert np.isinf(np.asarray(want["Out"][0])).all()


def test_zero_rows_give_jax_s_nan_gradients():
    x = _zero_row(_rand(5, 7, seed=6))
    _, grads = check("cos_sim", {"X": [x], "Y": [_rand(5, 7, seed=7)]}, {},
                     wrt=("X", "Y"))
    assert np.isnan(grads[0][1]).all() and np.isfinite(grads[0][0]).all()


def test_npair_loss_helper_raises_in_both():
    with pytest.raises(NotImplementedError):
        _run("npair_loss_helper", {}, {})
    with pytest.raises(NotImplementedError):
        jax_lowering("npair_loss_helper")(None, {}, {})


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
def _replayed(n, high):
    """The samples the port's lowering draws first from a fresh
    torch.Generator() (the CPU default seed), replayed from its own
    clone."""
    return torch.randint(0, high, (n,), generator=torch.Generator())


def _hand_in(monkeypatch, samples):
    def randint(key, shape, lo, hi, *a, **k):
        assert tuple(shape) == tuple(samples.shape)
        return jnp.asarray(samples.numpy().astype(np.int32))

    monkeypatch.setattr(jax.random, "randint", randint)


DRAW_CASES = {
    "nce": ("nce", {"Input": [_rand(5, 4, seed=60)],
                    "Label": [np.array([[0], [9], [3], [3], [11]],
                                       np.int64)],
                    "Weight": [_rand(12, 4, seed=61)],
                    "Bias": [_rand(12, 1, seed=62)]},
            {"num_total_classes": 12, "num_neg_samples": 6},
            ["Input", "Weight", "Bias"], "Cost", 6, 12),
    "nce_no_bias_1d_label": ("nce", {"Input": [_rand(4, 3, seed=63)],
                                     "Label": [np.array([1, 2, 0, 7],
                                                        np.int64)],
                                     "Weight": [_rand(8, 3, seed=64)]},
                             {"num_total_classes": 8, "num_neg_samples": 5},
                             ["Input", "Weight"], "Cost", 5, 8),
    "sampled_softmax": ("sampled_softmax_with_cross_entropy",
                        {"Logits": [_rand(6, 10, seed=65)],
                         "Label": [np.array([[1, 4], [0, 2], [9, 9], [3, 5],
                                             [7, 8], [6, 0]], np.int64)]},
                        {"num_samples": 8, "num_true": 2}, ["Logits"],
                        "Loss", 8, 10),
    "sampled_softmax_hits": ("sampled_softmax_with_cross_entropy",
                             {"Logits": [_rand(4, 3, seed=66)],
                              "Label": [np.array([[0], [1], [2], [1]],
                                                 np.int64)]},
                             {"num_samples": 5}, ["Logits"], "Loss", 5, 3),
}


@pytest.mark.parametrize("case", sorted(DRAW_CASES))
def test_draws_with_the_samples_handed_in(case, monkeypatch):
    op, ins, attrs, wrt, out, n, high = DRAW_CASES[case]
    _hand_in(monkeypatch, _replayed(n, high))
    check(op, ins, attrs, wrt=tuple(wrt), out_slot=out)


def test_draws_support_uniformity_and_seeding():
    """The samples come from the run's generator: in [0, classes), about
    uniform (each of 10 classes within 5 sigma of 1/10 over 50000 draws),
    the same for the same seed and not for another."""
    from paddle_tpu_torch.ops.loss_ops import uniform_samples

    def draw(seed, n=50000, high=10):
        g = torch.Generator()
        g.manual_seed(seed)
        return uniform_samples(LowerContext(torch.device("cpu"), g), n,
                               high, torch.device("cpu"))

    s = draw(1)
    assert int(s.min()) == 0 and int(s.max()) == 9
    counts = np.bincount(s.numpy(), minlength=10)
    sigma = np.sqrt(50000 * 0.1 * 0.9)
    assert np.abs(counts - 5000).max() < 5 * sigma, counts
    assert torch.equal(s, draw(1)) and not torch.equal(s, draw(2))
    # the lowering takes its negatives from the context's generator
    g = torch.Generator()
    g.manual_seed(3)
    ins = {k: [torch.from_numpy(a) for a in v]
           for k, v in DRAW_CASES["nce"][1].items()}
    a = pt_lowering("nce")(LowerContext(torch.device("cpu"), g), ins,
                           DRAW_CASES["nce"][2])["Cost"][0]
    g.manual_seed(3)
    b = pt_lowering("nce")(LowerContext(torch.device("cpu"), g), ins,
                           DRAW_CASES["nce"][2])["Cost"][0]
    assert torch.equal(a, b)


def test_the_draws_stay_live_when_unread():
    assert {"nce", "sampled_softmax_with_cross_entropy"} <= \
        pt_lowering_mod.DRAWS
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data(name="x", shape=[None, 4], dtype="float32")
        lab = fluid.data(name="lab", shape=[None, 1], dtype="int64")
        fluid.layers.nce(x, lab, num_total_classes=12, num_neg_samples=3)
        logits = fluid.layers.fc(x, 10)
        fluid.layers.sampled_softmax_with_cross_entropy(logits, lab, 4)
        y = fluid.layers.mean(x)
    plan = pt_lowering_mod.live_plan(main, [y.name])
    live = {op.type for op in plan.ops[0]}
    assert {"nce", "sampled_softmax_with_cross_entropy"} <= live


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _all_layers(fl):
    L = fl.layers
    x = fl.data(name="x", shape=[None, 6], dtype="float32")
    y = fl.data(name="y", shape=[None, 6], dtype="float32")
    lab = fl.data(name="lab", shape=[None, 1], dtype="int64")
    flab = fl.data(name="flab", shape=[None, 6], dtype="float32")
    one = fl.data(name="one", shape=[None, 1], dtype="float32")
    outs = [L.reduce_min(x, dim=1), L.reduce_prod(x, dim=[0], keep_dim=True),
            L.reduce_all(L.cast(x, "bool")), L.reduce_any(L.cast(x, "bool"),
                                                          dim=-1)]
    outs += L.split(x, 3, dim=1) + L.split(x, [1, 5], dim=-1)
    outs += [L.l2_normalize(x, axis=1), L.mul(x, L.transpose(y, [1, 0])),
             L.sum([x, y]), L.cos_sim(x, y),
             L.bilinear_tensor_product(x, y, 4, act="tanh"),
             L.bilinear_tensor_product(x, y, 3, bias_attr=False)]
    outs += list(L.mean_iou(lab, lab, 5))
    outs += [L.square_error_cost(x, y), L.smooth_l1(x, y, x, y, sigma=2.0),
             L.smooth_l1(x, y), L.dice_loss(L.softmax(x), lab),
             L.kldiv_loss(x, y, "batchmean"), L.kldiv_loss(x, y, "none"),
             L.npair_loss(x, y, one), L.mse_loss(x, y),
             L.sigmoid_cross_entropy_with_logits(x, flab, normalize=True),
             L.center_loss(x, lab, 5, 0.2),
             L.bpr_loss(x, lab), L.rank_loss(one, one, one),
             L.margin_rank_loss(one, one, one, margin=0.2),
             L.teacher_student_sigmoid_loss(one, one),
             L.sampled_softmax_with_cross_entropy(x, lab, 3),
             L.nce(x, lab, 10, num_neg_samples=4),
             L.hsigmoid(x, lab, 6), L.cross_entropy2(L.softmax(x), lab),
             L.huber_loss(x, y, 1.0)]
    ids = fl.data(name="ids", shape=[None, 5], dtype="int64", lod_level=1)
    outs += list(L.edit_distance(ids, ids))
    return outs


def test_every_layer_builds_the_reference_s_program():
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            outs = _all_layers(fl)
        progs.append((main, start, [(o.name, o.shape) for o in outs]))
    (jm, js, jo), (pm, ps, po) = progs
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert po == jo
    called = {op.type for op in pm.global_block().ops}
    assert set(LOSS_OPS + MATH_OPS + OTHER_OPS) - {
        "npair_loss_helper", "frobenius_norm", "kron", "dot",
        "squared_l2_distance", "hinge_loss", "precision_recall"} <= called


def test_the_layers_run_like_the_jax_package():
    """A program of the deterministic layers, run by both packages from the
    same startup values: every output within 1e-6 of the largest, the
    centers' update included, and the gradients of a summed loss."""
    rng = np.random.default_rng(8)
    feed = {"x": rng.normal(size=(6, 6)).astype(np.float32),
            "y": rng.normal(size=(6, 6)).astype(np.float32),
            "lab": np.array([[1], [4], [0], [2], [3], [1]], np.int64),
            "one": rng.normal(size=(6, 1)).astype(np.float32)}
    feed["flab"] = (feed["y"] > 0).astype(np.float32)
    res = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        start.random_seed = 5
        with fl.program_guard(main, start):
            L = fl.layers
            x = fl.data(name="x", shape=[None, 6], dtype="float32")
            y = fl.data(name="y", shape=[None, 6], dtype="float32")
            lab = fl.data(name="lab", shape=[None, 1], dtype="int64")
            flab = fl.data(name="flab", shape=[None, 6], dtype="float32")
            one = fl.data(name="one", shape=[None, 1], dtype="float32")
            h = L.fc(x, 6, act="tanh")
            parts = [L.reduce_sum(L.cos_sim(h, y)),
                     L.reduce_sum(L.square_error_cost(h, y)),
                     L.dice_loss(L.softmax(h), lab),
                     L.kldiv_loss(h, L.softmax(y), "batchmean"),
                     L.npair_loss(h, y, one), L.mse_loss(h, y),
                     L.reduce_mean(L.sigmoid_cross_entropy_with_logits(
                         h, flab)),
                     L.reduce_mean(L.center_loss(h, lab, 5, 0.2)),
                     L.reduce_mean(L.bpr_loss(h, lab)),
                     L.reduce_mean(L.smooth_l1(h, y)),
                     L.reduce_mean(L.hsigmoid(h, lab, 6)),
                     L.reduce_mean(L.cross_entropy2(L.softmax(h), lab)),
                     L.reduce_sum(L.bilinear_tensor_product(h, y, 3)),
                     L.reduce_mean(L.l2_normalize(h, axis=1)),
                     L.reduce_sum(L.reduce_min(h, dim=1)),
                     L.reduce_sum(L.reduce_prod(L.sigmoid(h), dim=[1]))]
            loss = L.sums(parts)
            grads = fl.backward.append_backward(loss)
            miou = L.mean_iou(lab, lab, 5)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        exe.run(start, scope=scope)
        if fl is jfluid:
            init = {p.name: np.asarray(scope[p.name])
                    for p in main.all_parameters()}
        else:
            for n, v in init.items():
                scope.set(n, torch.from_numpy(v.copy()))
        fetch = parts + [loss] + [g for _, g in grads] + list(miou)
        centers = [p.name for p in main.all_parameters()
                   if "center_loss" in p.name]
        out = exe.run(main, feed=feed, scope=scope, fetch_list=fetch)
        res.append([np.asarray(o) for o in out]
                   + [np.asarray(scope[n]) for n in centers])
    assert len(res[0]) == len(res[1])
    for i, (a, w) in enumerate(zip(res[1], res[0])):
        assert_close(a, w, 1e-5 if i >= 17 else FWD_TOL, "fetch %d" % i)
