"""The 18 op types of paddle_tpu/ops/misc_ops.py not ported before
(py_func, similarity_focus, merge_selected_rows,
get_tensor_from_selected_rows, deformable_psroi_pooling, tree_conv,
isinf_any, isnan_any, shard_index, hash, row_conv, unfold, im2sequence,
cvm, fsp, warpctc, space_to_depth, affine_channel) and their layers, in
the port against the JAX package, on the CPU.

- Each op type's port lowering against the JAX lowering
  (``test_torch_nn_ops_tail.check``: outputs 1e-6 of the largest value,
  jax.vjp gradients 1e-5 of the largest). ``warpctc`` is held with
  frozen steps past LogitsLength, labels padded with the blank (0 and the
  last class), LabelLength inferred, a label of length 0, and alignments
  that cannot exist (a label longer than its logits, a repeat with no
  room for its blank): there the loss is ~1e30 and the gradient is jax's
  ``logaddexp`` derivative, which ``F.ctc_loss`` and torch.logaddexp do
  not give (held too). ``hash`` with ``num_hash`` > 1 raises in both
  packages (its second constant does not fit in uint32).
- ``py_func``: a program with a host forward and a custom backward, and
  one with several outputs and no backward, run like the JAX package's.
- The layers build the same Program JSON in both packages.
- The JAX package's own tests of these ops run on the port through
  ``test_torch_rcnn.reference_tests`` (their ``fluid`` the port's;
  ``import paddle_tpu.fluid.framework`` and the distributions module
  redirected to the port's for the call): test_crf_ctc's and
  test_sequence_and_rnn's warpctc tests, test_tree_conv's two static
  tests, test_gradients_pyfunc's three py_func tests, test_final_parity's
  similarity_focus, selected-rows, deformable-ROI and image_resize_short
  tests, test_parity_sweep's conv-transpose and adaptive_pool3d tests,
  test_ops_numeric's conv2d_transpose test, and
  test_detection_distributions' three distribution tests. Left out:
  test_tree_conv's ``test_dygraph_tree_conv`` and test_parity_sweep's
  ``test_dygraph_conv3dtranspose_seqconv_rowconv``, which need dygraph
  (ROADMAP Queue 1 item 9).
"""
import json
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.misc_ops import JaxLogAddExp
from paddle_tpu_torch.ops.registry import LowerContext, get_lowering
from test_torch_activations import assert_close
from test_torch_detection import _rand, _unif, pt_lowering
from test_torch_nn_ops_tail import check
from test_torch_rcnn import reference_tests

MISC_OPS = (
    "py_func", "similarity_focus", "merge_selected_rows",
    "get_tensor_from_selected_rows", "deformable_psroi_pooling",
    "tree_conv", "isinf_any", "isnan_any", "shard_index", "hash",
    "row_conv", "unfold", "im2sequence", "cvm", "fsp", "warpctc",
    "space_to_depth", "affine_channel")


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


def _ctc(b, t, c, labels, blank, logits_len=None, label_len=None, seed=0):
    """warpctc inputs: logits (b, t, c), labels padded with the blank."""
    ins = {"Logits": [2.0 * _rand(b, t, c, seed=seed)],
           "Label": [np.array(labels, np.int32)]}
    if logits_len is not None:
        ins["LogitsLength"] = [np.array(logits_len, np.int64)]
    if label_len is not None:
        ins["LabelLength"] = [np.array(label_len, np.int64)]
    return ins


def _tree_edges():
    return np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6], [0, 0]],
                     [[1, 2], [2, 3], [2, 4], [1, 5], [0, 0], [0, 0]]],
                    np.int32)


def _case(name):
    """(op, ins, attrs, wrt, out_slot)."""
    img = _rand(2, 3, 6, 7, seed=1)
    rois = np.array([[1.0, 0.5, 5.0, 4.5], [0.0, 0.0, 6.9, 5.9],
                     [3.2, 2.1, 9.0, 8.0]], np.float32)
    bidx = np.array([0, 1, 1], np.int32)
    dps = {"spatial_scale": 1.0, "pooled_height": 2, "pooled_width": 3,
           "sample_per_part": 2, "trans_std": 0.1}
    return {
        "warpctc": ("warpctc", _ctc(3, 8, 6, [[1, 2, 3, 0], [4, 4, 0, 0],
                                              [5, 1, 5, 2]], 0, [8, 6, 7],
                                    [3, 2, 4]), {"blank": 0},
                    ("Logits",), "Loss"),
        "warpctc_inferred_lengths": ("warpctc", _ctc(
            3, 7, 5, [[1, 2, 0, 0], [3, 0, 0, 0], [2, 2, 4, 1]], 0),
            {"blank": 0, "norm_by_times": True}, ("Logits",), "Loss"),
        "warpctc_blank_last_frozen": ("warpctc", _ctc(
            4, 9, 6, [[0, 1, 5, 5], [2, 2, 2, 5], [5, 5, 5, 5], [3, 4, 0, 1]],
            5, [9, 4, 6, 2], seed=3), {"blank": 5}, ("Logits",), "Loss"),
        "warpctc_infeasible": ("warpctc", _ctc(
            3, 3, 5, [[1, 2, 3, 4], [2, 2, 0, 0], [1, 3, 0, 0]], 0,
            [3, 2, 3], [4, 2, 2], seed=4), {"blank": 0}, ("Logits",),
            "Loss"),
        "similarity_focus_axis1": ("similarity_focus", {"X": [_rand(
            2, 3, 4, 5, seed=2)]}, {"axis": 1, "indexes": [0, 2]}, (), "Out"),
        "similarity_focus_axis3": ("similarity_focus", {"X": [_rand(
            2, 3, 4, 5, seed=2)]}, {"axis": 3, "indexes": [1]}, (), "Out"),
        "merge_selected_rows": ("merge_selected_rows", {"X": [img]}, {},
                                ("X",), "Out"),
        "get_tensor_from_selected_rows": ("get_tensor_from_selected_rows",
                                          {"X": [img]}, {}, ("X",), "Out"),
        "deformable_ps": ("deformable_psroi_pooling", {
            "Input": [_rand(2, 12, 6, 7, seed=5)], "ROIs": [rois],
            "Trans": [0.5 * _rand(3, 2, 2, 3, seed=6)],
            "RoisBatchIdx": [bidx]},
            dict(dps, output_dim=2, group_size=[2, 3],
                 position_sensitive=True, part_size=[2, 3]),
            ("Input", "ROIs", "Trans"), "Output"),
        "deformable_plain": ("deformable_psroi_pooling", {
            "Input": [img], "ROIs": [rois],
            "Trans": [0.5 * _rand(3, 2, 1, 2, seed=7)],
            "RoisBatchIdx": [bidx]},
            dict(dps, output_dim=3, group_size=[1, 1],
                 position_sensitive=False, part_size=[1, 2]),
            ("Input", "ROIs", "Trans"), "Output"),
        "deformable_no_trans": ("deformable_psroi_pooling", {
            "Input": [img], "ROIs": [rois[:2]]},
            dict(dps, output_dim=3, no_trans=True, position_sensitive=False),
            ("Input", "ROIs"), "Output"),
        "tree_conv": ("tree_conv", {
            "NodesVector": [_rand(2, 6, 4, seed=8)],
            "EdgeSet": [_tree_edges()],
            "Filter": [_rand(4, 3, 5, 2, seed=9)]}, {"max_depth": 3},
            ("NodesVector", "Filter"), "Out"),
        "isinf_any": ("isinf_any", {"X": [np.array([1.0, np.inf, 2.0],
                                                   np.float32)]}, {}, (),
                      "Out"),
        "isinf_any_none": ("isinf_any", {"X": [img]}, {}, (), "Out"),
        "isnan_any": ("isnan_any", {"X": [np.array([1.0, np.nan],
                                                   np.float32)]}, {}, (),
                      "Out"),
        "isnan_any_none": ("isnan_any", {"X": [img]}, {}, (), "Out"),
        "shard_index": ("shard_index", {"X": [np.array(
            [[0], [7], [13], [19], [-3], [10]], np.int64)]},
            {"index_num": 20, "nshards": 3, "shard_id": 1,
             "ignore_value": -1}, (), "Out"),
        "hash": ("hash", {"X": [np.array([[0, 1], [123456789, -7],
                                          [2 ** 31 - 1, 42]], np.int64)]},
                 {"mod_by": 10007, "num_hash": 1}, (), "Out"),
        "row_conv": ("row_conv", {"X": [_rand(2, 6, 4, seed=10)],
                                  "Filter": [_rand(3, 4, seed=11)]}, {},
                     ("X", "Filter"), "Out"),
        "unfold": ("unfold", {"X": [img]}, {
            "kernel_sizes": [2, 3], "strides": [1, 2], "paddings": [1, 0],
            "dilations": [1, 1]}, ("X",), "Y"),
        "unfold_four_pads_dilated": ("unfold", {"X": [img]}, {
            "kernel_sizes": [2, 2], "strides": [2, 1],
            "paddings": [1, 0, 2, 1], "dilations": [2, 1]}, ("X",), "Y"),
        "im2sequence": ("im2sequence", {"X": [img]}, {
            "kernels": [3, 2], "strides": [1, 2], "paddings": [1, 1, 1, 1]},
            ("X",), "Out"),
        "cvm": ("cvm", {"X": [_rand(4, 6, seed=12)],
                        "CVM": [_rand(4, 2, seed=13)]}, {"use_cvm": True},
                ("X",), "Y"),
        "cvm_off": ("cvm", {"X": [_rand(4, 6, seed=12)],
                            "CVM": [_rand(4, 2, seed=13)]},
                    {"use_cvm": False}, ("X",), "Y"),
        "fsp": ("fsp", {"X": [img], "Y": [_rand(2, 4, 6, 7, seed=14)]}, {},
                ("X", "Y"), "Out"),
        "space_to_depth": ("space_to_depth", {"X": [_rand(2, 3, 4, 6,
                                                          seed=15)]},
                           {"blocksize": 2}, ("X",), "Out"),
        "affine_channel": ("affine_channel", {
            "X": [img], "Scale": [_rand(3, seed=16)],
            "Bias": [_rand(3, seed=17)]}, {}, ("X", "Scale", "Bias"),
            "Out"),
        "affine_channel_nhwc": ("affine_channel", {
            "X": [img], "Scale": [_rand(7, seed=16)]},
            {"data_layout": "NHWC"}, ("X", "Scale"), "Out"),
    }[name]


CASES = sorted(
    ["warpctc", "warpctc_inferred_lengths", "warpctc_blank_last_frozen",
     "warpctc_infeasible", "similarity_focus_axis1",
     "similarity_focus_axis3", "merge_selected_rows",
     "get_tensor_from_selected_rows", "deformable_ps", "deformable_plain",
     "deformable_no_trans", "tree_conv", "isinf_any", "isinf_any_none",
     "isnan_any", "isnan_any_none", "shard_index", "hash", "row_conv",
     "unfold", "unfold_four_pads_dilated", "im2sequence", "cvm", "cvm_off",
     "fsp", "space_to_depth", "affine_channel", "affine_channel_nhwc"])


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, slot = _case(case)
    check(op, ins, attrs, wrt, slot)


def test_every_op_is_covered():
    covered = {_case(c)[0] for c in CASES} | {"py_func"}
    assert covered == set(MISC_OPS)
    for op in MISC_OPS:
        pt_lowering(op)


def test_hash_of_several_raises_in_both():
    import jax.numpy as jnp
    from paddle_tpu.ops.registry import get_lowering as jax_lowering

    x = np.array([[1, 2]], np.int64)
    attrs = {"mod_by": 100, "num_hash": 2}
    with pytest.raises(OverflowError):
        jax_lowering("hash")(None, {"X": [jnp.asarray(x)]}, dict(attrs))
    with pytest.raises(OverflowError, match="uint32"):
        pt_lowering("hash")(None, {"X": [torch.from_numpy(x)]}, dict(attrs))


def test_warpctc_infeasible_is_not_torch_s():
    """Where no alignment exists the loss sits at ~1e30 and jax's
    logaddexp derivative, not torch's, shapes the gradient; where one
    exists the value is F.ctc_loss's."""
    op, ins, attrs, wrt, slot = _case("warpctc_infeasible")
    got, grads = check(op, ins, attrs, wrt, slot)
    assert (got["Loss"][0][:, 0] > 1e29).tolist() == [True, True, False]
    a = torch.full((3,), -1e30, requires_grad=True)
    JaxLogAddExp.apply(a, a.detach().clone().requires_grad_()).sum()\
        .backward()
    b = torch.full((3,), -1e30, requires_grad=True)
    torch.logaddexp(b, b.detach().clone()).sum().backward()
    assert a.grad.tolist() == [1.0] * 3 and b.grad.tolist() == [0.5] * 3
    op, ins, attrs, wrt, slot = _case("warpctc")
    got, _ = check(op, ins, attrs, wrt, slot)
    lp = torch.log_softmax(torch.from_numpy(ins["Logits"][0]), -1)
    want = F.ctc_loss(lp.transpose(0, 1), torch.from_numpy(
        ins["Label"][0]).long(), torch.from_numpy(ins["LogitsLength"][0]),
        torch.from_numpy(ins["LabelLength"][0]), blank=0,
        reduction="none").numpy()
    np.testing.assert_allclose(got["Loss"][0][:, 0], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# py_func programs
# ---------------------------------------------------------------------------
def _py_func_net(fl, with_backward):
    x = fl.data(name="x", shape=[3, 4], dtype="float32")
    y = fl.data(name="y", shape=[3, 4], dtype="float32")
    blk = fl.default_main_program().current_block()
    if not with_backward:
        s = blk.create_var(name="sum_out", dtype="float32", shape=(3, 4))
        p = blk.create_var(name="prod_out", dtype="float32", shape=(3, 4))
        return list(fl.layers.py_func(lambda a, b: (a + b, a * b), [x, y],
                                      [s, p]))
    h = fl.layers.fc(x, 4, param_attr=fl.ParamAttr(
        name="pw", initializer=fl.initializer.Constant(0.3)))
    t = blk.create_var(name="tanh_out", dtype="float32", shape=(3, 4))
    t = fl.layers.py_func(
        lambda a: np.tanh(a), h, t,
        backward_func=lambda a, out, dout: dout * (1.0 - out * out))
    loss = fl.layers.reduce_sum(fl.layers.square(fl.layers.elementwise_mul(
        t, y)))
    return [t, loss] + list(fl.gradients(loss, [x, h]))


@pytest.mark.parametrize("with_backward", [True, False])
def test_py_func_programs_run_like_the_jax_package(with_backward):
    """A host tanh with its custom backward inside a gradient (the JAX
    package cannot differentiate a program holding a py_func without
    one), and a two-output py_func with none."""
    rng = np.random.default_rng(2)
    feed = {"x": rng.normal(size=(3, 4)).astype(np.float32),
            "y": rng.normal(size=(3, 4)).astype(np.float32)}
    res = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            outs = _py_func_net(fl, with_backward)
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(start, scope=scope)
        res.append([np.asarray(o) for o in exe.run(
            main, feed=feed, fetch_list=outs, scope=scope)])
    assert len(res[1]) == (4 if with_backward else 2)
    for i, (a, w) in enumerate(zip(res[1], res[0])):
        assert_close(a, w, 1e-6, "output %d" % i)


def test_py_func_without_inputs_puts_its_outputs_on_the_run_device():
    """A py_func with no inputs has no input device to follow: its outputs
    go to the run's device, here the meta device (which no input could
    have led them to), and a CPU run fetches them on the CPU."""
    pt_unique_name.switch()
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        out = main.current_block().create_var(name="const_out",
                                              dtype="float32", shape=(2, 3))
        fluid.layers.py_func(lambda: np.arange(6.0).reshape(2, 3), [], out)
    op, = [op for op in main.global_block().ops if op.type == "py_func"]
    ctx = LowerContext(torch.device("meta"))
    got, = get_lowering("py_func")(ctx, {"X": []}, dict(op.attrs))["Out"]
    assert got.device.type == "meta" and tuple(got.shape) == (2, 3)
    exe = fluid.Executor(fluid.CPUPlace())
    val, = exe.run(main, fetch_list=[out], scope=fluid.Scope())
    np.testing.assert_array_equal(
        np.asarray(val), np.arange(6.0, dtype=np.float32).reshape(2, 3))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layers(fl):
    L = fl.layers
    img = fl.data(name="img", shape=[None, 3, 8, 8], dtype="float32")
    seq = fl.data(name="seq", shape=[None, 6, 4], dtype="float32")
    ids = fl.data(name="ids", shape=[None, 1], dtype="int64")
    rois = fl.data(name="rois", shape=[None, 4], dtype="float32")
    trans = fl.data(name="trans", shape=[None, 2, 2, 2], dtype="float32")
    nodes = fl.data(name="nodes", shape=[None, 5, 4], dtype="float32")
    edges = fl.data(name="edges", shape=[None, 4, 2], dtype="int32")
    logits = fl.data(name="logits", shape=[None, 6, 5], dtype="float32")
    label = fl.data(name="label", shape=[None, 3], dtype="int32")
    llen = fl.data(name="llen", shape=[None], dtype="int64")
    return [
        L.im2sequence(img, filter_size=[3, 2], stride=[1, 2]),
        L.row_conv(seq, 2, act="relu"),
        L.shard_index(ids, 20, 2, 0), L.hash(ids, 1000),
        L.unfold(img, [2, 2], 2, 1),
        L.similarity_focus(img, 1, [0, 2]),
        L.get_tensor_from_selected_rows(L.merge_selected_rows(img)),
        L.deformable_roi_pooling(img, rois, trans, pooled_height=2,
                                 pooled_width=2),
        L.deformable_roi_pooling(img, rois, None, no_trans=True,
                                 group_size=[1, 3], pooled_height=2,
                                 pooled_width=2, position_sensitive=True),
        L.tree_conv(nodes, edges, 3, 2, max_depth=2),
        L.continuous_value_model(seq, L.slice(seq, [2], [0], [2]), False),
        L.fsp_matrix(img, img),
        L.space_to_depth(img, 2),
        L.affine_channel(img, L.create_parameter([3], "float32"),
                         L.create_parameter([3], "float32"), act="tanh"),
        L.warpctc(logits, label, blank=4, norm_by_times=True,
                  input_length=llen),
        L.has_inf(img), L.has_nan(img),
    ]


def test_every_layer_builds_the_reference_s_program():
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            outs = _layers(fl)
        progs.append((main, start, [(o.name, o.shape) for o in outs]))
    (jm, js, jo), (pm, ps, po) = progs
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert po == jo


# ---------------------------------------------------------------------------
# the JAX package's own tests of these ops, on the port
# ---------------------------------------------------------------------------
REFERENCE_TESTS = (
    ("test_crf_ctc", "test_warpctc_matches_torch_oracle"),
    ("test_sequence_and_rnn", "test_warpctc_matches_trivial_case"),
    ("test_tree_conv", "test_tree_conv_matches_bfs_oracle"),
    ("test_tree_conv", "test_tree_conv_depth3_and_training"),
    ("test_gradients_pyfunc", "test_py_func_forward_and_custom_backward"),
    ("test_gradients_pyfunc", "test_py_func_multi_io_no_backward"),
    ("test_gradients_pyfunc", "test_py_func_in_training_graph"),
    ("test_final_parity", "test_similarity_focus_reference_example"),
    ("test_final_parity", "test_selected_rows_compat_identity"),
    ("test_final_parity", "test_deformable_roi_pooling_zero_trans_matches_avg"),
    ("test_final_parity", "test_deformable_roi_pooling_position_sensitive"),
    ("test_final_parity", "test_image_resize_short"),
    ("test_parity_sweep", "test_conv3d_transpose_vs_torch"),
    ("test_parity_sweep", "test_conv2d_transpose_vs_torch"),
    ("test_parity_sweep", "test_adaptive_pool3d"),
    ("test_ops_numeric", "test_conv2d_transpose_fwd_grad_vs_torch"),
    ("test_detection_distributions",
     "test_normal_distribution_kl_and_sampling"),
    ("test_detection_distributions", "test_categorical_log_prob"),
    ("test_detection_distributions",
     "test_mvn_diag_entropy_matches_reference_formula"),
)


@pytest.mark.parametrize("module,test", REFERENCE_TESTS,
                         ids=["%s::%s" % t for t in REFERENCE_TESTS])
def test_reference_test_passes_on_the_port(module, test, monkeypatch):
    from paddle_tpu_torch.fluid.layers import distributions

    mod = reference_tests(module)
    mod.gradients = fluid.gradients
    # the tests' in-body imports of the JAX package's framework and
    # distributions reach the port's for the call
    monkeypatch.setattr(jfluid, "framework", pt_framework)
    monkeypatch.setitem(sys.modules, "paddle_tpu.fluid.layers.distributions",
                        distributions)
    getattr(mod, test)()
