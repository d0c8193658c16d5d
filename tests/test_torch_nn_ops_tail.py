"""The last 20 op types of paddle_tpu/ops/nn_ops.py (conv3d, the
transposed convolutions, pool3d, the group/instance/data/weight/spectral
norms, lrn, the interpolations, grid_sampler, affine_grid, pixel_shuffle,
temporal_shift, add_position_encoding) and their layers, in the port
against the JAX package, on the CPU.

- Each op type's port lowering against the JAX lowering on the same
  seeded numpy inputs and attrs: outputs within FWD_TOL (1e-6) of the
  largest value, and the gradient through torch.autograd against jax.vjp
  under one random cotangent within GRAD_TOL (1e-5) of the largest JAX
  gradient (``check``: the JAX outputs and jax.vjp of a case are one
  jitted function; cases with a tensor read on the host, OutSize and
  OutputShape, run op by op).
- The traps: ``nearest_interp`` is jax.image.resize's half-pixel nearest
  (torch's ``nearest-exact``, not ``nearest``); ``bilinear_interp`` and
  ``trilinear_interp`` antialias when they shrink, so each is held up,
  down and both at once; ``lrn``'s alpha is not divided by n (held
  against ``F.local_response_norm`` too); ``grid_sampler`` and
  ``affine_grid`` map corners to corners (``align_corners=True``), with
  grid points on and past the borders; the transposed convolutions
  follow ``lax.conv_transpose``'s explicit padding, which is torch's only
  at p = (k - 1)/2, and raise for groups > 1 in both packages;
  ``spectral_norm`` is differentiated in Weight and U through its power
  iterations (V is overwritten by the first one: no gradient).
- The layers of fluid/layers/nn.py that append these ops, and
  ``WeightNormParamAttr``, build the same Program JSON in both packages
  (startup included); a weight-normalised fc runs like the JAX package's
  from the JAX startup (loss and the g and v gradients).
"""
import json

import jax
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
from paddle_tpu_torch.fluid.io import params_from_numpy
from test_torch_activations import assert_close
from test_torch_detection import _jax_run, _port_run, _rand, pt_lowering

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

NN_TAIL_OPS = (
    "conv3d", "conv2d_transpose", "conv3d_transpose", "pool3d",
    "group_norm", "instance_norm", "data_norm", "norm", "norm_except_dim",
    "weight_norm_reparam", "lrn", "spectral_norm", "bilinear_interp",
    "nearest_interp", "trilinear_interp", "grid_sampler", "affine_grid",
    "pixel_shuffle", "temporal_shift", "add_position_encoding")


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


def check(op_type, ins, attrs, wrt=(), out_slot="Out", eager=False,
          fwd_tol=FWD_TOL, grad_tol=GRAD_TOL, seed=5):
    """The port's lowering against the JAX lowering: every output within
    fwd_tol of its largest value, and with `wrt` the gradients of out_slot
    in those inputs within grad_tol of the largest JAX gradient. `eager`
    runs the JAX lowering op by op (a value read on the host). Returns
    the port's outputs and gradients."""
    got, ggot, cot = _port_run(op_type, ins, attrs, wrt, out_slot, seed)
    want, gwant = _jax_run(op_type, ins, attrs, wrt, out_slot, cot, eager)
    assert set(got) >= set(want), (op_type, set(want) - set(got))
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for a, w in zip(got[slot], want[slot]):
            assert_close(a, w, fwd_tol, "%s.%s" % (op_type, slot))
    assert len(ggot) == len(gwant) == sum(len(ins[s]) for s in wrt)
    for i, (a, w) in enumerate(zip(ggot, gwant)):
        assert_close(a, w, grad_tol, "%s grad %d" % (op_type, i))
    return got, ggot


def _pos(*shape, seed=0, lo=0.5, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _grid(n, oh, ow, seed=0):
    """Grid points in [-1.3, 1.3], with exact corners, edges and integer
    pixel positions among them."""
    g = np.random.default_rng(seed).uniform(-1.3, 1.3,
                                             size=(n, oh, ow, 2))
    g[0, 0, 0] = [-1.0, -1.0]
    g[0, 0, 1] = [1.0, 1.0]
    g[0, 1, 0] = [1.0, -1.0]
    g[-1, -1, -1] = [0.0, 0.5]
    return g.astype(np.float32)


def _case(name):
    """(op, ins, attrs, wrt, out_slot, eager)."""
    x4 = _rand(2, 3, 6, 7, seed=1)
    x5 = _rand(2, 3, 5, 6, 4, seed=2)
    ct = {"Input": [_rand(2, 3, 5, 6, seed=3)]}
    cases = {
        "conv3d": ("conv3d", {"Input": [x5],
                              "Filter": [_rand(4, 3, 3, 2, 3, seed=4)]},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                    "dilations": [1, 1, 2]}, ("Input", "Filter"),
                   "Output", False),
        "conv3d_groups": ("conv3d", {"Input": [x5],
                                     "Filter": [_rand(6, 1, 3, 3, 3,
                                                      seed=4)]},
                          {"groups": 3, "paddings": [1, 1, 1]},
                          ("Input", "Filter"), "Output", False),
        "conv3d_transpose": ("conv3d_transpose", {
            "Input": [_rand(2, 3, 3, 4, 3, seed=5)],
            "Filter": [_rand(3, 2, 3, 2, 3, seed=6)]},
            {"strides": [2, 1, 2], "paddings": [1, 0, 1],
             "output_padding": [1, 0, 0]}, ("Input", "Filter"), "Output",
            False),
        "pool3d_max_ceil": ("pool3d", {"X": [x5]},
                            {"pooling_type": "max", "ksize": [2, 3, 2],
                             "strides": [2, 2, 2], "paddings": [0, 1, 0],
                             "ceil_mode": True}, ("X",), "Out", False),
        "pool3d_avg_exclusive": ("pool3d", {"X": [x5]},
                                 {"pooling_type": "avg", "ksize": [3, 3, 2],
                                  "strides": [2, 2, 1],
                                  "paddings": [1, 1, 0]}, ("X",), "Out",
                                 False),
        "pool3d_avg_inclusive": ("pool3d", {"X": [x5]},
                                 {"pooling_type": "avg", "ksize": [3, 3, 2],
                                  "strides": [2, 2, 1],
                                  "paddings": [1, 1, 1],
                                  "exclusive": False}, ("X",), "Out", False),
        "pool3d_global": ("pool3d", {"X": [x5]},
                          {"pooling_type": "avg", "global_pooling": True},
                          ("X",), "Out", False),
        "pool3d_adaptive": ("pool3d", {"X": [x5]},
                            {"pooling_type": "max", "ksize": [2, 3, 2],
                             "adaptive": True}, ("X",), "Out", False),
        "group_norm": ("group_norm", {"X": [_rand(2, 6, 4, 5, seed=7)],
                                      "Scale": [_rand(6, seed=8)],
                                      "Bias": [_rand(6, seed=9)]},
                       {"groups": 3, "epsilon": 1e-5},
                       ("X", "Scale", "Bias"), "Y", False),
        "group_norm_plain": ("group_norm", {"X": [_rand(2, 4, 3, seed=7)]},
                             {"groups": 2}, ("X",), "Y", False),
        "instance_norm": ("instance_norm", {"X": [x4],
                                            "Scale": [_rand(3, seed=8)],
                                            "Bias": [_rand(3, seed=9)]},
                          {"epsilon": 1e-5}, ("X", "Scale", "Bias"), "Y",
                          False),
        "data_norm": ("data_norm", {
            "X": [_rand(5, 4, seed=10)], "BatchSize": [_pos(4, lo=50, hi=90)],
            "BatchSum": [_rand(4, seed=11) * 10],
            "BatchSquareSum": [_pos(4, seed=12, lo=100, hi=200)]},
            {"epsilon": 1e-5},
            ("X", "BatchSize", "BatchSum", "BatchSquareSum"), "Y", False),
        "norm": ("norm", {"X": [x4]}, {"axis": 1, "epsilon": 1e-10},
                 ("X",), "Out", False),
        "norm_except_dim_0": ("norm_except_dim",
                              {"V": [_rand(4, 3, 2, seed=13)]}, {"dim": 0},
                              ("V",), "Out", False),
        "norm_except_dim_all": ("norm_except_dim",
                                {"V": [_rand(4, 3, seed=13)]}, {"dim": -1},
                                ("V",), "Out", False),
        "weight_norm_reparam_1": ("weight_norm_reparam", {
            "V": [_rand(4, 3, seed=14)], "G": [_rand(3, seed=15)]},
            {"dim": 1}, ("V", "G"), "Out", False),
        "weight_norm_reparam_all": ("weight_norm_reparam", {
            "V": [_rand(4, 3, seed=14)], "G": [_rand(1, seed=15)]},
            {"dim": -1}, ("V", "G"), "Out", False),
        "lrn": ("lrn", {"X": [_rand(2, 7, 3, 4, seed=16)]}, {},
                ("X",), "Out", False),
        "lrn_large_alpha": ("lrn", {"X": [_rand(2, 7, 3, 4, seed=16)]},
                            {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.6},
                            ("X",), "Out", False),
        "spectral_norm_dim0": ("spectral_norm", {
            "Weight": [_rand(4, 3, 2, seed=17)], "U": [_rand(4, seed=18)],
            "V": [_rand(6, seed=19)]}, {"dim": 0, "power_iters": 2},
            ("Weight", "U"), "Out", False),
        "spectral_norm_dim1": ("spectral_norm", {
            "Weight": [_rand(4, 3, 2, seed=17)], "U": [_rand(3, seed=18)],
            "V": [_rand(8, seed=19)]}, {"dim": 1, "power_iters": 1},
            ("Weight", "U"), "Out", False),
        "bilinear_up": ("bilinear_interp", {"X": [_rand(2, 3, 4, 5, seed=20)]},
                        {"out_h": 7, "out_w": 9}, ("X",), "Out", False),
        "bilinear_down": ("bilinear_interp", {"X": [_rand(2, 3, 8, 9,
                                                          seed=21)]},
                          {"out_h": 3, "out_w": 4}, ("X",), "Out", False),
        "bilinear_up_down": ("bilinear_interp", {"X": [_rand(1, 2, 5, 9,
                                                             seed=22)]},
                             {"out_h": 8, "out_w": 4}, ("X",), "Out", False),
        "bilinear_one_dim": ("bilinear_interp", {"X": [_rand(1, 2, 5, 6,
                                                             seed=22)]},
                             {"out_h": 5, "out_w": 4}, ("X",), "Out", False),
        "bilinear_scale": ("bilinear_interp", {"X": [x4]}, {"scale": 1.5},
                           ("X",), "Out", False),
        "bilinear_outsize": ("bilinear_interp", {
            "X": [x4], "OutSize": [np.array([3, 10], np.int32)]},
            {"out_h": 99, "out_w": 99}, ("X",), "Out", True),
        "nearest_up": ("nearest_interp", {"X": [_rand(2, 3, 4, 5, seed=23)]},
                       {"out_h": 7, "out_w": 12}, ("X",), "Out", False),
        "nearest_down": ("nearest_interp", {"X": [_rand(2, 3, 9, 8,
                                                        seed=24)]},
                         {"out_h": 4, "out_w": 3}, ("X",), "Out", False),
        "nearest_scale": ("nearest_interp", {"X": [x4]}, {"scale": 0.7},
                          ("X",), "Out", False),
        "trilinear": ("trilinear_interp", {"X": [_rand(1, 2, 3, 6, 4,
                                                       seed=25)]},
                      {"out_d": 5, "out_h": 4, "out_w": 4}, ("X",), "Out",
                      False),
        "grid_sampler": ("grid_sampler", {"X": [x4], "Grid": [_grid(2, 4, 5)]},
                         {}, ("X", "Grid"), "Output", False),
        "affine_grid": ("affine_grid", {"Theta": [_rand(2, 2, 3, seed=26)]},
                        {"output_shape": [2, 3, 4, 5]}, ("Theta",), "Output",
                        False),
        "affine_grid_tensor_shape": ("affine_grid", {
            "Theta": [_rand(2, 2, 3, seed=26)],
            "OutputShape": [np.array([2, 3, 6, 1], np.int32)]}, {},
            ("Theta",), "Output", True),
        "pixel_shuffle": ("pixel_shuffle", {"X": [_rand(2, 8, 3, 4, seed=27)]},
                          {"upscale_factor": 2}, ("X",), "Out", False),
        "temporal_shift": ("temporal_shift", {"X": [_rand(6, 8, 2, 3,
                                                          seed=28)]},
                           {"seg_num": 3, "shift_ratio": 0.25}, ("X",),
                           "Out", False),
        "add_position_encoding": ("add_position_encoding", {
            "X": [_rand(2, 7, 8, seed=29)]}, {"alpha": 0.7, "beta": 1.3},
            ("X",), "Out", False),
    }
    for k, s, p, d, o in ((3, 1, 1, 1, 0), (2, 2, 0, 1, 0), (3, 2, 1, 1, 1),
                          (4, 2, 1, 1, 0), (3, 2, 0, 2, 0), (5, 3, 2, 1, 2)):
        cases["conv2d_transpose_k%d_s%d_p%d_d%d_o%d" % (k, s, p, d, o)] = (
            "conv2d_transpose",
            dict(ct, Filter=[_rand(3, 4, k, k, seed=k + s)]),
            {"strides": [s, s], "paddings": [p, p], "dilations": [d, d],
             "output_padding": [o, o]}, ("Input", "Filter"), "Output",
            False)
    return cases[name]


CASES = sorted(
    ["conv3d", "conv3d_groups", "conv3d_transpose", "pool3d_max_ceil",
     "pool3d_avg_exclusive", "pool3d_avg_inclusive", "pool3d_global",
     "pool3d_adaptive", "group_norm", "group_norm_plain", "instance_norm",
     "data_norm", "norm", "norm_except_dim_0", "norm_except_dim_all",
     "weight_norm_reparam_1", "weight_norm_reparam_all", "lrn",
     "lrn_large_alpha", "spectral_norm_dim0", "spectral_norm_dim1",
     "bilinear_up", "bilinear_down", "bilinear_up_down", "bilinear_one_dim",
     "bilinear_scale", "bilinear_outsize", "nearest_up", "nearest_down",
     "nearest_scale", "trilinear", "grid_sampler", "affine_grid",
     "affine_grid_tensor_shape", "pixel_shuffle", "temporal_shift",
     "add_position_encoding"]
    + ["conv2d_transpose_k%d_s%d_p%d_d%d_o%d" % c for c in (
        (3, 1, 1, 1, 0), (2, 2, 0, 1, 0), (3, 2, 1, 1, 1), (4, 2, 1, 1, 0),
        (3, 2, 0, 2, 0), (5, 3, 2, 1, 2))])


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, slot, eager = _case(case)
    check(op, ins, attrs, wrt, slot, eager)


def test_every_op_is_covered():
    assert {_case(c)[0] for c in CASES} == set(NN_TAIL_OPS)
    for op in NN_TAIL_OPS:
        pt_lowering(op)


def test_nearest_is_half_pixel_not_torch_nearest():
    x = _rand(1, 1, 4, 5, seed=30)
    got, _ = check("nearest_interp", {"X": [x]}, {"out_h": 7, "out_w": 3})
    t = torch.from_numpy(x)
    exact = F.interpolate(t, size=(7, 3), mode="nearest-exact").numpy()
    np.testing.assert_array_equal(got["Out"][0], exact)
    assert not np.array_equal(
        got["Out"][0], F.interpolate(t, size=(7, 3), mode="nearest").numpy())


def test_bilinear_shrink_antialiases():
    """Shrinking averages over the widened triangle (not torch's two-tap
    bilinear); growing is torch's half-pixel bilinear."""
    x = _rand(1, 2, 9, 8, seed=31)
    down, _ = check("bilinear_interp", {"X": [x]}, {"out_h": 4, "out_w": 3})
    t = torch.from_numpy(x)
    plain = F.interpolate(t, size=(4, 3), mode="bilinear",
                          align_corners=False).numpy()
    assert np.abs(down["Out"][0] - plain).max() > 1e-2
    up, _ = check("bilinear_interp", {"X": [x]}, {"out_h": 13, "out_w": 11})
    np.testing.assert_allclose(up["Out"][0], F.interpolate(
        t, size=(13, 11), mode="bilinear", align_corners=False).numpy(),
        atol=1e-5)


def test_lrn_alpha_is_not_divided_by_n():
    x = _rand(2, 6, 3, 3, seed=32)
    got, _ = check("lrn", {"X": [x]}, {"n": 5, "k": 2.0, "alpha": 0.3,
                                       "beta": 0.75})
    # torch's divides alpha by n: n·alpha gives the op's value
    ref = F.local_response_norm(torch.from_numpy(x), 5, alpha=5 * 0.3,
                                beta=0.75, k=2.0).numpy()
    np.testing.assert_allclose(got["Out"][0], ref, rtol=1e-5, atol=1e-6)


def test_grid_sampler_is_align_corners_true():
    x = _rand(2, 3, 5, 6, seed=33)
    g = np.random.default_rng(4).uniform(-1, 1, size=(2, 4, 3, 2)).astype(
        np.float32)
    got, _ = check("grid_sampler", {"X": [x], "Grid": [g]}, {},
                   out_slot="Output")
    ref = F.grid_sample(torch.from_numpy(x), torch.from_numpy(g),
                        mode="bilinear", padding_mode="border",
                        align_corners=True).numpy()
    np.testing.assert_allclose(got["Output"][0], ref, atol=1e-5)


def test_conv_transpose_groups_raise_in_both():
    ins = {"Input": [_rand(1, 4, 3, 3)], "Filter": [_rand(4, 1, 3, 3)]}
    from paddle_tpu.ops.registry import get_lowering as jax_lowering
    for low, args in ((pt_lowering, {k: [torch.from_numpy(a) for a in v]
                                     for k, v in ins.items()}),
                      (jax_lowering, {k: [jax.numpy.asarray(a) for a in v]
                                      for k, v in ins.items()})):
        with pytest.raises(NotImplementedError, match="groups>1"):
            low("conv2d_transpose")(None, args, {"groups": 2})


# ---------------------------------------------------------------------------
# layers: the same Program JSON in both packages
# ---------------------------------------------------------------------------
def _all_layers(fl):
    L = fl.layers
    x = fl.data(name="x", shape=[None, 3, 8, 8], dtype="float32")
    v = fl.data(name="v", shape=[None, 3, 4, 6, 6], dtype="float32")
    s = fl.data(name="s", shape=[None, 5, 8], dtype="float32")
    outs = [
        L.conv3d(v, 4, 3, padding=1, act="relu"),
        L.conv3d(v, 6, [2, 3, 3], stride=[1, 2, 2], groups=3,
                 bias_attr=False),
        L.conv2d_transpose(x, 4, filter_size=3, padding=1),
        L.conv2d_transpose(x, 2, output_size=16, stride=2, padding=1,
                           act="sigmoid"),
        L.conv2d_transpose(x, 2, filter_size=[2, 4], stride=[2, 1]),
        L.conv3d_transpose(v, 2, filter_size=2, stride=2),
        L.conv3d_transpose(v, 2, output_size=[8, 12, 12], stride=2),
        L.pool3d(v, 2, "max", 2), L.pool3d(v, 3, "avg", 1, 1,
                                           ceil_mode=True, exclusive=False),
        L.pool3d(v, global_pooling=True),
        L.adaptive_pool2d(x, [3, 2], "avg"), L.adaptive_pool3d(v, 2),
        L.instance_norm(x), L.group_norm(x, 3, act="relu"),
        L.group_norm(x, 1, param_attr=False, bias_attr=False),
        L.data_norm(s), L.lrn(x, n=3, alpha=0.01),
        L.image_resize(x, out_shape=[5, 7]),
        L.image_resize(x, scale=1.5, resample="NEAREST"),
        L.image_resize(fl.layers.transpose(x, [0, 2, 3, 1]), [4, 4],
                       data_format="NHWC"),
        L.resize_bilinear(x, [4, 12]), L.resize_nearest(x, scale=0.5),
        L.resize_trilinear(v, [5, 3, 3]), L.image_resize_short(x, 5),
        L.pixel_shuffle(fl.layers.concat([x, x, x, x], axis=1), 2),
        L.temporal_shift(x, 1), L.add_position_encoding(s, 0.5, 2.0),
    ]
    theta = fl.data(name="theta", shape=[None, 2, 3], dtype="float32")
    grid = L.affine_grid(theta, [2, 3, 5, 4])
    outs += [grid, L.grid_sampler(x, grid)]
    w = fl.layers.create_parameter([6, 5], "float32", name="sw")
    outs.append(L.spectral_norm(w, dim=1, power_iters=3))
    outs.append(L.fc(s, 4, num_flatten_dims=2,
                     param_attr=fl.WeightNormParamAttr(dim=1, name="wn")))
    outs.append(L.fc(s, 3, param_attr=fl.WeightNormParamAttr()))
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
    called |= {op.type for op in ps.global_block().ops}
    assert set(NN_TAIL_OPS) - {"norm"} <= called


def _weight_norm_net(fl):
    x = fl.data(name="x", shape=[None, 6], dtype="float32")
    h = fl.layers.fc(x, 5, act="tanh",
                     param_attr=fl.WeightNormParamAttr(dim=1))
    y = fl.layers.fc(h, 2, param_attr=fl.WeightNormParamAttr())
    loss = fl.layers.mean(fl.layers.square(y))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss


def test_weight_norm_trains_like_the_jax_package():
    """The JAX startup (g seeded from ||v||) carried into the port: the
    same losses over 3 SGD steps and the same g and v gradients."""
    built = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        start.random_seed = 3
        with fl.program_guard(main, start):
            loss = _weight_norm_net(fl)
        built.append((main, start, loss))
    (jm, js, jl), (pm, ps, pl) = built
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    persist = [v.name for v in js.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in persist},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pm.all_parameters())
    assert any(p.endswith(".w_g") for p in params)
    grads = [p + "@GRAD" for p in params]
    xv = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    for step in range(3):
        fetch = [jl.name] + (grads if step == 0 else [])
        jout = jexe.run(jm, feed={"x": xv}, scope=jscope, fetch_list=fetch)
        pout = exe.run(pm, feed={"x": xv}, scope=scope, fetch_list=fetch)
        assert abs(float(pout[0]) - float(np.asarray(jout[0]))) <= \
            1e-5 * abs(float(np.asarray(jout[0])))
        for name, a, w in zip(params, pout[1:], jout[1:]):
            assert_close(np.asarray(a), np.asarray(w), 1e-4, name)
