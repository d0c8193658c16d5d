"""The last 22 op types of paddle_tpu/ops/tensor_ops.py (strided_slice,
shape, size, scatter, scatter_nd_add, unstack, tile, pad, pad2d,
pad_constant_like, arg_min, where_index, multiplex, linspace, eye, diag,
roll, flip, crop, label_smooth, share_data, print) and their layers in
fluid/layers/nn.py, tensor.py and control_flow.py, in the port against
the JAX package, on the CPU.

- Each op type's port lowering against the JAX lowering
  (``test_torch_nn_ops_tail.check``): outputs within 1e-6 of the largest
  value, integers equal (int64 where jax gives int32), and the gradient
  against jax.vjp within 1e-5 of the largest. jax's index rules are held:
  a negative scatter index wraps once, one out of range is dropped; ties
  in ``arg_min`` go to the first; ``strided_slice`` walks backwards with
  a negative stride; ``crop`` with Y and no offsets keeps all of X, as the
  JAX lowering does; ``linspace`` is float32 whatever ``dtype`` says.
  ``print`` writes the same text as the JAX package's ``jax.debug.print``.
- Every new layer builds the same Program JSON in both packages; a
  program of them runs to the same values as the JAX package's; ``Print``
  prints even when nothing reads its output (the port's liveness keeps
  host effects).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_activations import assert_close
from test_torch_detection import _rand, pt_lowering
from test_torch_nn_ops_tail import check

TENSOR_TAIL_OPS = (
    "strided_slice", "shape", "size", "scatter", "scatter_nd_add",
    "unstack", "tile", "pad", "pad2d", "pad_constant_like", "arg_min",
    "where_index", "multiplex", "linspace", "eye", "diag", "roll", "flip",
    "crop", "label_smooth", "share_data", "print")


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


def _ties():
    x = _rand(4, 6, seed=3)
    x[0, 1] = x[0, 4] = x[0].min() - 1.0
    x[2, :] = 0.5
    return x


def _case(name):
    """(op, ins, attrs, wrt, out_slot, eager)."""
    x = _rand(4, 5, 6, seed=1)
    img = _rand(2, 3, 4, 5, seed=2)
    return {
        "strided_slice": ("strided_slice", {"Input": [x]},
                          {"axes": [0, 2], "starts": [1, 0],
                           "ends": [10, 5], "strides": [2, 2]},
                          ("Input",), "Out", False),
        "strided_slice_negative": ("strided_slice", {"Input": [x]},
                                   {"axes": [1, 2], "starts": [-1, 5],
                                    "ends": [-10, 0], "strides": [-2, -3]},
                                   ("Input",), "Out", False),
        "shape": ("shape", {"Input": [x]}, {}, (), "Out", False),
        "size": ("size", {"Input": [x]}, {}, (), "Out", False),
        "scatter": ("scatter", {"X": [_rand(6, 3, seed=4)],
                                "Ids": [np.array([4, -1, 0, 9], np.int32)],
                                "Updates": [_rand(4, 3, seed=5)]},
                    {"overwrite": True}, ("X", "Updates"), "Out", False),
        "scatter_add": ("scatter", {"X": [_rand(6, 3, seed=4)],
                                    "Ids": [np.array([[2], [2], [5], [-6]],
                                                     np.int64)],
                                    "Updates": [_rand(4, 3, seed=5)]},
                        {"overwrite": False}, ("X", "Updates"), "Out",
                        False),
        "scatter_nd_add": ("scatter_nd_add", {
            "X": [_rand(4, 5, 3, seed=6)],
            "Index": [np.array([[1, 2], [1, 2], [-1, 0], [3, 7], [0, -5]],
                               np.int32)],
            "Updates": [_rand(5, 3, seed=7)]}, {}, ("X", "Updates"), "Out",
            False),
        "scatter_nd_add_full": ("scatter_nd_add", {
            "X": [_rand(4, 5, seed=6)],
            "Index": [np.array([[[1, 2], [3, 4]], [[1, 2], [0, 0]]],
                               np.int64)],
            "Updates": [_rand(2, 2, seed=7)]}, {}, ("X", "Updates"), "Out",
            False),
        "unstack": ("unstack", {"X": [x]}, {"axis": 1}, ("X",), "Y", False),
        "tile": ("tile", {"X": [_rand(2, 3, seed=8)]},
                 {"repeat_times": [2, 1, 3]}, ("X",), "Out", False),
        "tile_short": ("tile", {"X": [_rand(2, 3, seed=8)]},
                       {"repeat_times": [3]}, ("X",), "Out", False),
        "pad": ("pad", {"X": [x]}, {"paddings": [1, 0, 0, 2, 3, 1],
                                    "pad_value": 0.5}, ("X",), "Out", False),
        "pad2d_constant": ("pad2d", {"X": [img]},
                           {"paddings": [1, 2, 0, 3], "pad_value": -1.0},
                           ("X",), "Out", False),
        "pad2d_reflect": ("pad2d", {"X": [img]},
                          {"paddings": [2, 1, 3, 1], "mode": "reflect"},
                          ("X",), "Out", False),
        "pad2d_edge": ("pad2d", {"X": [img]},
                       {"paddings": [2, 1, 3, 1], "mode": "edge"},
                       ("X",), "Out", False),
        "pad2d_nhwc_reflect": ("pad2d", {"X": [img]},
                               {"paddings": [1, 1, 2, 0], "mode": "reflect",
                                "data_format": "NHWC"}, ("X",), "Out",
                               False),
        "pad_constant_like": ("pad_constant_like", {
            "X": [x], "Y": [_rand(2, 5, 3, seed=9)]}, {"pad_value": 2.0},
            ("Y",), "Out", False),
        "arg_min": ("arg_min", {"X": [_ties()]}, {"axis": 1}, (), "Out",
                    False),
        "arg_min_axis0": ("arg_min", {"X": [_ties()]}, {"axis": 0}, (),
                          "Out", False),
        "where_index": ("where_index", {
            "Condition": [_rand(3, 4, seed=10) > 0.3]}, {}, (), "Out", True),
        "multiplex": ("multiplex", {
            "X": [_rand(4, 3, seed=11), _rand(4, 3, seed=12),
                  _rand(4, 3, seed=13)],
            "Ids": [np.array([[2], [0], [1], [2]], np.int32)]}, {},
            ("X",), "Out", False),
        "linspace": ("linspace", {}, {"start": -1.5, "stop": 2.25, "num": 7,
                                      "dtype": "float64"}, (), "Out", False),
        "linspace_tensors": ("linspace", {
            "Start": [np.array(0.1, np.float32)],
            "Stop": [np.array(1.0, np.float32)],
            "Num": [np.array(10, np.int32)]}, {}, (), "Out", True),
        "eye": ("eye", {}, {"num_rows": 3, "num_columns": 5,
                            "dtype": "float32"}, (), "Out", False),
        "eye_square": ("eye", {}, {"num_rows": 4, "dtype": "int32"}, (),
                       "Out", False),
        "diag": ("diag", {"Diagonal": [_rand(5, seed=14)]}, {},
                 ("Diagonal",), "Out", False),
        "diag_of_matrix": ("diag", {"Diagonal": [_rand(4, 4, seed=14)]}, {},
                           ("Diagonal",), "Out", False),
        "roll": ("roll", {"X": [x]}, {"shifts": [2, -1], "axis": [0, 2]},
                 ("X",), "Out", False),
        "roll_flat": ("roll", {"X": [x]}, {"shifts": [7], "axis": []},
                      ("X",), "Out", False),
        "flip": ("flip", {"X": [x]}, {"axis": [0, 2]}, ("X",), "Out", False),
        "crop": ("crop", {"X": [x]}, {"shape": [2, 3, 4],
                                      "offsets": [1, 2, 0]}, ("X",), "Out",
                 False),
        "crop_like": ("crop", {"X": [x], "Y": [_rand(3, 2, 2, seed=15)]},
                      {"offsets": [0, 3, 1]}, ("X",), "Out", False),
        "crop_like_no_offsets": ("crop", {"X": [x],
                                          "Y": [_rand(3, 2, 2, seed=15)]},
                                 {"offsets": []}, ("X",), "Out", False),
        "label_smooth": ("label_smooth", {"X": [np.eye(5, dtype=np.float32)[
            [0, 3, 1]]]}, {"epsilon": 0.2}, ("X",), "Out", False),
        "label_smooth_prior": ("label_smooth", {
            "X": [np.eye(5, dtype=np.float32)[[0, 3, 1]]],
            "PriorDist": [np.full((1, 5), 0.2, np.float32)]},
            {"epsilon": 0.1}, ("X", "PriorDist"), "Out", False),
        "share_data": ("share_data", {"X": [x]}, {}, ("X",), "Out", False),
    }[name]


CASES = sorted(
    ["strided_slice", "strided_slice_negative", "shape", "size", "scatter",
     "scatter_add", "scatter_nd_add", "scatter_nd_add_full", "unstack",
     "tile", "tile_short", "pad", "pad2d_constant", "pad2d_reflect",
     "pad2d_edge", "pad2d_nhwc_reflect", "pad_constant_like", "arg_min",
     "arg_min_axis0", "where_index", "multiplex", "linspace",
     "linspace_tensors", "eye", "eye_square", "diag", "diag_of_matrix",
     "roll", "roll_flat", "flip", "crop", "crop_like",
     "crop_like_no_offsets", "label_smooth", "label_smooth_prior",
     "share_data"])


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, slot, eager = _case(case)
    check(op, ins, attrs, wrt, slot, eager)


def test_every_op_is_covered():
    covered = {_case(c)[0] for c in CASES} | {"print"}
    assert covered == set(TENSOR_TAIL_OPS)
    for op in TENSOR_TAIL_OPS:
        pt_lowering(op)


def test_print_writes_what_the_jax_package_writes(capfd):
    import jax.numpy as jnp
    from paddle_tpu.ops.registry import get_lowering as jax_lowering

    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 4
    attrs = {"message": "x is: "}
    jax_lowering("print")(None, {"In": [jnp.asarray(x)]}, dict(attrs))
    jax_out = capfd.readouterr().out
    got = pt_lowering("print")(None, {"In": [torch.from_numpy(x)]},
                               dict(attrs))
    assert np.array_equal(got["Out"][0].numpy(), x)
    assert capfd.readouterr().out == jax_out
    assert jax_out.startswith("x is: [[0.")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layers(fl, with_where_index=True):
    L = fl.layers
    x = fl.data(name="x", shape=[4, 5, 6], dtype="float32")
    img = fl.data(name="img", shape=[2, 3, 4, 5], dtype="float32")
    ids = fl.data(name="ids", shape=[3], dtype="int64")
    idx = fl.data(name="idx", shape=[2, 2], dtype="int64")
    outs = {
        "where": L.where(L.greater_than(x, L.zeros_like(x)), x,
                         L.scale(x, -1.0)),
        "scatter_nd": L.scatter_nd(idx, L.reshape(L.slice(
            x, [0, 1, 2], [0, 0, 0], [2, 1, 1]), [2, 1]), [4, 5, 1]),
        "rank": L.rank(x), "shape": L.shape(x), "size": L.size(x),
        "crop_tensor": L.crop_tensor(x, [2, 3, 4], [1, 1, 2]),
        "crop_like": L.crop(x, L.slice(x, [0, 1], [0, 0], [3, 2]), [1, 2, 0]),
        "flatten_contiguous": L.flatten_contiguous(x, 1, 2),
        "mish": L.mish(x),
        "unstack1": L.unstack(x, axis=1)[3],
        "strided_slice": L.strided_slice(x, [0, 2], [3, 5], [0, 0],
                                         [-1, -2]),
        "scatter": L.scatter(L.slice(x, [2], [0], [1]), ids,
                             L.slice(x, [0, 2], [0, 0], [3, 1])),
        "scatter_nd_add": L.scatter_nd_add(x, idx, L.reshape(L.slice(
            x, [0, 1], [0, 0], [2, 1]), [2, 6])),
        "pad": L.pad(x, [0, 1, 2, 0, 1, 1], 0.5),
        "pad2d": L.pad2d(img, [1, 0, 2, 1], mode="reflect"),
        "pad_constant_like": L.pad_constant_like(x, L.slice(
            x, [1], [0], [2]), 1.0),
        "label_smooth": L.label_smooth(L.softmax(x), epsilon=0.2),
        "multiplex": L.multiplex([L.slice(x, [2], [0], [1]),
                                  L.slice(x, [2], [1], [2])],
                                 L.cast(L.slice(ids, [0], [0], [1]),
                                        "int32") * 0 + L.fill_constant(
                                     [4, 1], "int32", 1)),
        "argmin": L.argmin(x, axis=2),
        "diag": L.diag(L.reshape(L.slice(x, [0, 1], [0, 0], [1, 1]), [6])),
        "eye": L.eye(3, 4, batch_shape=[2]),
        "has_inf": L.has_inf(x), "has_nan": L.has_nan(x),
        "isfinite": L.isfinite(x),
        "linspace": L.linspace(0.0, 1.0, 5),
        "ones": L.ones([2, 3], "float32"), "zeros": L.zeros([3], "int64"),
        "ones_like": L.ones_like(x),
        "print": L.Print(x, message="x: "),
    }
    arr = L.create_array("float32")
    L.array_write(L.slice(x, [0], [0], [1]), 0, array=arr)
    L.array_write(L.slice(x, [0], [1], [2]), 1, array=arr)
    outs["tensor_array_to_tensor"], outs["array_sizes"] = \
        L.tensor_array_to_tensor(arr, axis=0)
    outs["create_tensor"] = L.create_tensor("float32", name="ct")
    if with_where_index:
        outs["where_index"] = L.where(L.greater_than(x, L.zeros_like(x)))
    L.Print(x, message="unread: ")
    return outs


def _feed():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    return {"x": x, "img": rng.normal(size=(2, 3, 4, 5)).astype(np.float32),
            "ids": np.array([3, 0, 1], np.int64),
            "idx": np.array([[1, 2], [3, 0]], np.int64)}


def _build(fl, un, with_where_index=True):
    un.switch()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        outs = _layers(fl, with_where_index)
    return main, start, outs


def test_every_layer_builds_the_reference_s_program():
    (jm, js, jo), (pm, ps, po) = (_build(jfluid, jax_unique_name),
                                  _build(fluid, pt_unique_name))
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert [(k, v.name, v.shape) for k, v in po.items()] == \
        [(k, v.name, v.shape) for k, v in jo.items()]


def test_the_layers_run_like_the_jax_package(capfd):
    """Every output of the layer program against the JAX package's run;
    both print the read and the unread Print. ``where`` with no x and y
    (where_index, a data-dependent shape) cannot run in the JAX package's
    compiled step, so it is held against numpy in a port run alone."""
    (jm, _, jo), (pm, _, po) = (_build(jfluid, jax_unique_name, False),
                                _build(fluid, pt_unique_name, False))
    names = [k for k in jo if k != "create_tensor"]
    jout = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=_feed(), fetch_list=[jo[k] for k in names],
        scope=jfluid.Scope())
    jax_text = capfd.readouterr().out
    pout = fluid.Executor(fluid.CPUPlace()).run(
        pm, feed=_feed(), fetch_list=[po[k] for k in names],
        scope=fluid.Scope())
    port_text = capfd.readouterr().out
    for k, a, w in zip(names, pout, jout):
        a, w = np.asarray(a), np.asarray(w)
        if k == "linspace":         # jax: float32 whatever dtype says
            assert a.dtype == w.dtype == np.float32
        if w.dtype == np.int32 and a.dtype != np.int32:
            assert a.dtype == np.int64, k
        assert_close(a, w, 1e-6, k)
    for text in (jax_text, port_text):
        assert "x: [[[" in text and "unread: [[[" in text
    assert sorted(port_text.splitlines()) == sorted(jax_text.splitlines())


def test_where_index_runs_in_a_port_program():
    pm, _, po = _build(fluid, pt_unique_name)
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pm, feed=_feed(), fetch_list=[po["where_index"]],
        scope=fluid.Scope())
    np.testing.assert_array_equal(
        got, np.stack(np.nonzero(_feed()["x"] > 0), axis=1))


@pytest.mark.parametrize("layer,args", [
    ("unique", ()), ("unique_with_counts", ()),
    ("filter_by_instag", (None, None, False))])
def test_refusing_layers_refuse_in_both(layer, args):
    """The layers whose output shape depends on the data raise in both
    packages, as the reference's do."""
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        with fl.program_guard(fl.Program(), fl.Program()):
            x = fl.data(name="x", shape=[6], dtype="int64")
            with pytest.raises(NotImplementedError):
                getattr(fl.layers, layer)(x, *args)
