"""The R-CNN and RetinaNet op lowerings against the JAX package, and the
reference's own detection tests run against the port, on the CPU.

- The 14 op types of ``paddle_tpu/ops/rcnn_ops.py``: each port lowering
  against the JAX lowering on the same seeded numpy inputs and attrs, by
  tests/test_torch_detection.py's rule (integers equal, floats within
  1e-6 of the largest value, gradients within 1e-5 of the largest).
- tests/test_rcnn_detection.py and tests/test_detection_distributions.py
  check the detection layers against numpy oracles and by their
  semantics (anchors, focal loss, target assigns, proposals, mAP, the
  SSD head and loss, NMS, YOLOv3). Each module is loaded afresh with its
  ``fluid``, ``framework`` and ``unique_name`` bound to the port's (an
  ``Executor()`` without a place runs on the CPU here) and its tests run
  as they are. Left out: the tests of modules the port does not have yet
  (``fluid.metrics``, ``layers.distributions``, the transpiler).
"""
import importlib.util
import os
import types

import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_detection import RCNN_CASES, check_case


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


@pytest.mark.parametrize("case", RCNN_CASES)
def test_lowering_matches_jax(case):
    check_case(case)


class _CpuFluid(types.ModuleType):
    """The port's fluid, with ``Executor()`` on the CPU by default."""

    def __getattr__(self, name):
        return getattr(fluid, name)

    @staticmethod
    def Executor(place=None):
        return fluid.Executor(place or fluid.CPUPlace())


def reference_tests(name):
    """tests/<name>.py loaded afresh, its fluid bound to the port's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        name + ".py")
    spec = importlib.util.spec_from_file_location("_on_port_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fluid = _CpuFluid("fluid")
    mod.framework = pt_framework
    mod.unique_name = pt_unique_name
    mod.global_scope = pt_executor.global_scope
    return mod


RCNN_TESTS = (
    "test_anchor_generator_matches_oracle",
    "test_sigmoid_focal_loss_matches_oracle", "test_target_assign_dense",
    "test_rpn_target_assign_dense_semantics",
    "test_retinanet_target_assign_labels_and_fg_num",
    "test_generate_proposals_shapes_and_nms",
    "test_detection_map_perfect_and_partial",
    "test_polygon_box_transform_oracle", "test_box_decoder_and_assign",
    "test_multi_box_head_and_ssd_train_step",
    "test_retinanet_detection_output_basic",
    "test_locality_aware_nms_merges_adjacent",
    "test_generate_proposal_labels_dense",
    "test_roi_perspective_transform_identity_quad",
    "test_roi_perspective_transform_trapezoid_homography",
    "test_generate_proposal_labels_excludes_crowd_rows",
    "test_generate_mask_labels_rasterizes_polygon",
    "test_fpn_distribute_and_collect")
DISTRIBUTION_TESTS = (
    "test_iou_similarity_and_box_coder", "test_multiclass_nms_static_shape",
    "test_ssd_loss_uses_labels", "test_yolov3_loss_runs",
    "test_multiclass_nms_adaptive_eta")


@pytest.mark.parametrize("test", RCNN_TESTS)
def test_reference_rcnn_test_passes_on_the_port(test):
    getattr(reference_tests("test_rcnn_detection"), test)()


@pytest.mark.parametrize("test", DISTRIBUTION_TESTS)
def test_reference_detection_test_passes_on_the_port(test):
    getattr(reference_tests("test_detection_distributions"), test)()


def test_the_reference_tests_named_exist():
    for name, tests in (("test_rcnn_detection", RCNN_TESTS),
                        ("test_detection_distributions",
                         DISTRIBUTION_TESTS)):
        mod = reference_tests(name)
        for t in tests:
            assert callable(getattr(mod, t)), (name, t)
