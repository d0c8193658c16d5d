"""The int8 quantization chain of fluid.contrib (quant, quantize and
slim's quantization with core.strategy) in the port, against the JAX
package, on the CPU.

- The 5 op types against the JAX lowerings on seeded numpy inputs: the
  three fake quant-dequant ops within 1e-6 of the largest value, their
  straight-through gradients against jax.vjp within 1e-6 of the largest;
  ``quantized_mul`` and ``quantized_conv2d`` outputs within 1e-6 of the
  largest, and their int32 accumulators equal to the JAX package's
  ``lax.dot_general`` / ``lax.conv_general_dilated`` at
  ``preferred_element_type=int32`` with no tolerance: strides, both
  padding forms, dilation, groups and depthwise, a batch of 1, a sum past
  2^24 (where an f32 sum is inexact), and ``quant_bits=16`` (an int32
  activation, sums that wrap past 2^31 as jax's int32 sum wraps).
- A weight not yet int8 converts as XLA converts float to int8 on the
  CPU: NaN to 0 and values outside the range to -128 or 127 (held over
  every edge value; ROADMAP.md Queue 3).
- The passes (QuantizationTransformPass with a cond sub-block,
  quantize_program, AddQuantDequantPass, QuantizationFreezePass,
  ConvertToInt8Pass, QuantizeTranspiler, QuantizationStrategy) give the
  same Program JSON, scale states and int8 weights in both packages.
- Post-training quantization (KL) of examples/quantize_int8.py's MLP and
  of a ResNet-18 at 32x32, each from one fp32 model saved by the JAX
  package: the same quantized program (the act_scale attrs aside), the
  same int8 weights, act_scales within 1e-6 relative, and logits: the
  MLP's within 1e-5 of the largest; ResNet-18's within the bound
  ``flip_bound`` derives from the activation roundings that fell the
  other way.
- The JAX package's own quantization tests (tests/test_quant.py, the
  quantization cases of tests/test_slim_framework.py and
  tests/test_slim.py::test_slim_quantization_reexport) run against the
  port: each module is loaded afresh with its ``fluid`` bound to the
  port's, and the modules its tests import in their bodies are the
  port's for the call.
- slim exports every name the JAX package's slim exports.
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jax_executor
from paddle_tpu.fluid import framework as jax_framework
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.contrib.slim.quantization import (
    quantization_pass as jqp)
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.contrib.slim.quantization import (
    quantization_pass as pqp)
from test_torch_activations import check
from test_torch_detection import _jax_run, _rand
from test_torch_rcnn import _CpuFluid

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh default programs (random seed 5, as tests/test_quant.py
    sets them), name generators and scopes of both packages."""
    old = (pt_framework.switch_main_program(pt_framework.Program()),
           pt_framework.switch_startup_program(pt_framework.Program()),
           pt_unique_name.switch(), pt_executor._scope_stack[:],
           jax_framework.switch_main_program(jax_framework.Program()),
           jax_framework.switch_startup_program(jax_framework.Program()),
           jax_unique_name.switch(), jax_executor._scope_stack[:])
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    jax_executor._scope_stack[:] = [jax_executor.Scope()]
    for fw in (pt_framework, jax_framework):
        fw.default_main_program().random_seed = 5
        fw.default_startup_program().random_seed = 5
    yield
    pt_framework.switch_main_program(old[0])
    pt_framework.switch_startup_program(old[1])
    pt_unique_name.switch(old[2])
    pt_executor._scope_stack[:] = old[3]
    jax_framework.switch_main_program(old[4])
    jax_framework.switch_startup_program(old[5])
    jax_unique_name.switch(old[6])
    jax_executor._scope_stack[:] = old[7]


# ---------------------------------------------------------------------------
# the five op types
# ---------------------------------------------------------------------------
def _ints(*shape, lo=-127, hi=127, seed=0):
    return np.random.default_rng(seed).integers(lo, hi + 1, size=shape)


FAKE_CASES = {
    "abs_max": ("fake_quantize_dequantize_abs_max",
                {"X": [_rand(4, 6, seed=1)]}, {"bit_length": 8}),
    "abs_max_4bit_with_ties": (
        "fake_quantize_dequantize_abs_max",
        {"X": [np.array([[0.5, -1.0, 0.25, 0.125], [1.75, -0.0625, 0.0,
                                                    2.0]], np.float32)]},
        {"bit_length": 4}),
    "channel_wise_conv": ("fake_channel_wise_quantize_dequantize_abs_max",
                          {"X": [_rand(5, 3, 3, 3, seed=2)]},
                          {"bit_length": 8, "quant_axis": 0}),
    "channel_wise_mul_16bit": (
        "fake_channel_wise_quantize_dequantize_abs_max",
        {"X": [_rand(7, 9, seed=3)]}, {"bit_length": 16, "quant_axis": 1}),
    "channel_wise_zero_channel": (
        "fake_channel_wise_quantize_dequantize_abs_max",
        {"X": [np.concatenate([np.zeros((1, 4), np.float32),
                               _rand(2, 4, seed=4)])]},
        {"bit_length": 8, "quant_axis": 0}),
    "moving_average_train": (
        "fake_quantize_dequantize_moving_average_abs_max",
        {"X": [_rand(3, 5, 4, seed=5)],
         "InScale": [np.array([0.7], np.float32)]},
        {"bit_length": 8, "moving_rate": 0.9}),
    "moving_average_is_test": (
        "fake_quantize_dequantize_moving_average_abs_max",
        {"X": [3 * _rand(3, 5, seed=6)],
         "InScale": [np.array([1.3], np.float32)]},
        {"bit_length": 8, "moving_rate": 0.9, "is_test": True}),
}


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_quant_dequant_ops_and_their_straight_through_gradients(case):
    op, ins, attrs = FAKE_CASES[case]
    got, grads = check(op, ins, attrs, wrt=("X",), fwd_tol=TOL,
                       grad_tol=TOL)
    if "is_test" in case:
        np.testing.assert_array_equal(got["OutScale"][0],
                                      ins["InScale"][0])


def _mul_case(bits, m, k, n, seed, w_int8=False, big=False):
    if big:                       # every product large and positive
        x = np.random.default_rng(seed).uniform(0.8, 1.0, (m, k))
        w = _ints(k, n, lo=100, hi=127, seed=seed + 1)
        act_scale = 1.0
    else:
        x = 2 * _rand(m, k, seed=seed)
        w = _ints(k, n, seed=seed + 1)
        act_scale = 2.5
    ws = list(np.random.default_rng(seed + 2).uniform(0.05, 1.0, n))
    return ({"X": [x.astype(np.float32)],
             "Y": [w.astype(np.int8 if w_int8 else np.float32)]},
            {"act_scale": act_scale, "weight_scale": ws, "quant_bits": bits})


MUL_CASES = {
    "plain": _mul_case(8, 6, 40, 9, 1),
    "int8_weights": _mul_case(8, 6, 40, 9, 2, w_int8=True),
    "batch_1": _mul_case(8, 1, 33, 5, 3),
    "3d_input": ({"X": [_rand(2, 3, 12, seed=4)],
                  "Y": [_ints(12, 7, seed=5).astype(np.float32)]},
                 {"act_scale": 1.5, "weight_scale": [0.5] * 7,
                  "quant_bits": 8}),
    "past_2^24": _mul_case(8, 4, 2048, 8, 6, big=True),
    "16_bit": _mul_case(16, 5, 24, 6, 7),
    "16_bit_wraps_past_2^31": _mul_case(16, 4, 1024, 8, 8, big=True),
}


def _conv_case(bits, x_shape, w_shape, seed, **attrs):
    attrs.setdefault("act_scale", 2.5)
    attrs["quant_bits"] = bits
    attrs["weight_scale"] = list(
        np.random.default_rng(seed).uniform(0.05, 1.0, w_shape[0]))
    return ({"Input": [2 * _rand(*x_shape, seed=seed + 1)],
             "Filter": [_ints(*w_shape, seed=seed + 2).astype(np.float32)]},
            attrs)


CONV_CASES = {
    "plain": _conv_case(8, (2, 4, 9, 9), (6, 4, 3, 3), 1),
    "stride_pad2": _conv_case(8, (2, 3, 10, 11), (5, 3, 3, 3), 2,
                              strides=[2, 1], paddings=[1, 2]),
    "pad4_dilation": _conv_case(8, (2, 3, 12, 10), (4, 3, 3, 2), 3,
                                paddings=[1, 2, 0, 1], dilations=[2, 1]),
    "groups": _conv_case(8, (2, 6, 8, 8), (4, 3, 3, 3), 4, groups=2,
                         paddings=[1, 1]),
    "depthwise": _conv_case(8, (2, 5, 7, 7), (5, 1, 3, 3), 5, groups=5,
                            paddings=[1, 1], strides=[2, 2]),
    "batch_1_1x1": _conv_case(8, (1, 16, 5, 5), (24, 16, 1, 1), 6),
    "past_2^24": ({"Input": [np.random.default_rng(8).uniform(
        0.8, 1.0, (2, 512, 5, 5)).astype(np.float32)],
        "Filter": [_ints(8, 512, 3, 3, lo=100, hi=127, seed=9).astype(
            np.float32)]},
        {"act_scale": 1.0, "weight_scale": [0.01] * 8, "quant_bits": 8,
         "paddings": [1, 1]}),
}


def test_quantized_conv2d_16_bit_raises_as_the_jax_lowering_does():
    """The JAX lowering's int32 activation and int8 filter are operands
    of different dtypes, which lax.conv_general_dilated refuses: the port
    refuses them too (a defect kept, ROADMAP.md Queue 3)."""
    ins, attrs = _conv_case(16, (2, 3, 6, 6), (4, 3, 3, 3), 7,
                            paddings=[1, 1])
    with pytest.raises(TypeError, match="dtypes"):
        _jax_run("quantized_conv2d", ins, attrs, (), "Output", None, True)
    with pytest.raises(TypeError, match="quant_bits=16"):
        pqp._quantized_conv2d(
            None, {k: [torch.from_numpy(v[0])] for k, v in ins.items()},
            attrs)


@pytest.mark.parametrize("case", sorted(MUL_CASES))
def test_quantized_mul_matches_jax(case):
    ins, attrs = MUL_CASES[case]
    check("quantized_mul", ins, attrs, fwd_tol=TOL)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantized_conv2d_matches_jax(case):
    ins, attrs = CONV_CASES[case]
    check("quantized_conv2d", ins, attrs, out_slot="Output", fwd_tol=TOL)


def _jax_mul_acc(ins, attrs):
    bits = attrs["quant_bits"]
    xq = jqp._quant_act(jnp.asarray(ins["X"][0]), attrs["act_scale"], bits)
    w = jnp.asarray(ins["Y"][0])
    wq = w if w.dtype == jnp.int8 else jnp.round(w).astype(jnp.int8)
    x2 = xq.reshape(-1, xq.shape[-1]) if xq.ndim > 2 else xq
    return np.asarray(jax.lax.dot_general(
        x2, wq, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))


def _jax_conv_acc(ins, attrs):
    bits = attrs["quant_bits"]
    xq = jqp._quant_act(jnp.asarray(ins["Input"][0]), attrs["act_scale"],
                        bits)
    wq = jnp.round(jnp.asarray(ins["Filter"][0])).astype(jnp.int8)
    pads = attrs.get("paddings", [0, 0])
    pad_seq = ((pads[0], pads[0]), (pads[1], pads[1])) \
        if len(pads) == 2 else ((pads[0], pads[2]), (pads[1], pads[3]))
    return np.asarray(jax.lax.conv_general_dilated(
        xq, wq, tuple(attrs.get("strides", [1, 1])), pad_seq,
        rhs_dilation=tuple(attrs.get("dilations", [1, 1])),
        feature_group_count=attrs.get("groups", 1),
        preferred_element_type=jnp.int32))


def _port_mul_acc(ins, attrs):
    xq = pqp._quant_act(torch.from_numpy(ins["X"][0]), attrs["act_scale"],
                        attrs["quant_bits"])
    wq = pqp._weight_int8(torch.from_numpy(ins["Y"][0]))
    x2 = xq.reshape(-1, xq.shape[-1]) if xq.dim() > 2 else xq
    return pqp.int_matmul(x2, wq).numpy()


def _port_conv_acc(ins, attrs):
    xq = pqp._quant_act(torch.from_numpy(ins["Input"][0]),
                        attrs["act_scale"], attrs["quant_bits"])
    wq = pqp._weight_int8(torch.from_numpy(ins["Filter"][0]))
    return pqp.int_conv2d(xq, wq, attrs.get("strides", [1, 1]),
                          attrs.get("paddings", [0, 0]),
                          attrs.get("dilations", [1, 1]),
                          attrs.get("groups", 1)).numpy()


@pytest.mark.parametrize("op, case", [("mul", c) for c in sorted(MUL_CASES)]
                         + [("conv", c) for c in sorted(CONV_CASES)])
def test_int32_accumulators_are_exactly_jax_s(op, case):
    ins, attrs = (MUL_CASES if op == "mul" else CONV_CASES)[case]
    want = (_jax_mul_acc if op == "mul" else _jax_conv_acc)(ins, attrs)
    got = (_port_mul_acc if op == "mul" else _port_conv_acc)(ins, attrs)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if "2^24" in case:
        # the case an f32 sum cannot hold: past 2^24, and summed in f32
        # it comes out wrong
        assert np.abs(want).max() > 2 ** 24
        if op == "mul":
            xq = pqp._quant_act(torch.from_numpy(ins["X"][0]), 1.0, 8)
            f32 = (xq.float() @ torch.from_numpy(ins["Y"][0])).numpy()
            assert (f32.astype(np.int64) != want).any()
    if "2^31" in case:
        exact = (pqp._quant_act(torch.from_numpy(ins["X"][0]), 1.0, 16)
                 .double() @ torch.from_numpy(ins["Y"][0]).double())
        assert float(exact.abs().max()) > 2 ** 31          # it wrapped
        assert (want.astype(np.float64) != exact.numpy()).any()


WEIGHT_EDGES = np.array(
    [0, 0.5, 1.5, -0.5, 126.6, 127, 127.4, 127.5, 128, 200, 255, 256, 300,
     -127, -128, -128.4, -128.6, -129, -200, -300, 32767, -32767, 1e10,
     -1e10, np.inf, -np.inf, np.nan], np.float32)


def test_weights_convert_to_int8_as_xla_converts_them():
    """``jnp.round(w).astype(jnp.int8)``, the JAX lowerings' conversion of
    a weight not yet int8, saturates on the CPU (NaN to 0), jitted or
    not; the port's saturate_int8 gives the same for every edge value
    (torch's own ``.to(torch.int8)`` wraps instead)."""
    want = np.asarray(jnp.round(jnp.asarray(WEIGHT_EDGES)).astype(jnp.int8))
    jitted = np.asarray(jax.jit(
        lambda w: jnp.round(w).astype(jnp.int8))(WEIGHT_EDGES))
    got = pqp.saturate_int8(torch.round(torch.from_numpy(
        WEIGHT_EDGES))).numpy()
    np.testing.assert_array_equal(want, jitted)
    np.testing.assert_array_equal(got, want)
    assert want[WEIGHT_EDGES == 300][0] == 127
    assert want[np.isnan(WEIGHT_EDGES)][0] == 0
    # and through the op: a 16-bit freeze leaves weights on the 32767 grid
    ins = {"X": [_rand(3, 27, seed=1)],
           "Y": [WEIGHT_EDGES.reshape(27, 1).copy()]}
    attrs = {"act_scale": 2.0, "weight_scale": [1.0], "quant_bits": 16}
    np.testing.assert_array_equal(_port_mul_acc(ins, attrs),
                                  _jax_mul_acc(ins, attrs))


# ---------------------------------------------------------------------------
# the passes: the same Program JSON
# ---------------------------------------------------------------------------
def _both(build):
    """build(fl) in each package: (jax result, port result)."""
    return build(jfluid), build(fluid)


def _json(prog):
    return json.loads(prog.to_json())


def _mlp_and_cond(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.data("x", [None, 8], "float32")
        img = fl.data("img", [None, 3, 8, 8], "float32")
        h = fl.layers.fc(x, 16, act="relu")
        c = fl.layers.conv2d(img, 4, 3, padding=1)
        c = fl.layers.pool2d(c, 2, "max", 2)
        pred = fl.layers.greater_than(
            fl.layers.reduce_sum(x), fl.layers.fill_constant([1], "float32",
                                                             0.0))
        out = fl.layers.cond(pred, lambda: fl.layers.fc(h, 4),
                             lambda: fl.layers.scale(
                                 fl.layers.fc(h, 4, act="relu"), 2.0))
        out = fl.layers.elementwise_add(
            out, fl.layers.fc(fl.layers.flatten(c), 4))
        loss = fl.layers.mean(out)
    return main, startup, loss


PASSES = {
    "transform": lambda fl, m, s: fl.contrib.quant.QuantizationTransformPass(
        weight_bits=8, activation_bits=8).apply(m, s),
    "quantize_program_16bit": lambda fl, m, s: fl.contrib.quant
    .quantize_program(m, s, weight_bits=16, activation_bits=16),
    "add_quant_dequant": lambda fl, m, s: fl.contrib.slim.quantization
    .AddQuantDequantPass().apply(m, s),
    "transpiler": lambda fl, m, s: fl.contrib.quantize.QuantizeTranspiler(
        activation_quantize_type="range_abs_max").training_transpile(m, s),
}


@pytest.mark.parametrize("name", sorted(PASSES))
def test_passes_give_the_same_program_json(name):
    def build(fl):
        main, startup, _ = _mlp_and_cond(fl)
        PASSES[name](fl, main, startup)
        return main, startup

    (jm, js), (pm, ps) = _both(build)
    assert _json(pm) == _json(jm)
    assert _json(ps) == _json(js)
    types = {op.type for b in pm.blocks for op in b.ops}
    assert types & {"fake_quantize_dequantize_moving_average_abs_max"}


def _qat_mlp(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.data("x", [None, 12], "float32")
        h = fl.layers.fc(x, 24, act="relu")
        logits = fl.layers.fc(h, 4)
    fl.contrib.quant.quantize_program(main, startup)
    main.random_seed = startup.random_seed = 5
    return main, startup, logits


@pytest.mark.parametrize("bits", [8, 16])
def test_freeze_and_int8_conversion_match_the_jax_package(bits):
    """One QAT forward in the JAX package (its scale states move), the
    state copied to the port; then each package freezes and converts:
    the same Program JSON and the same int8 weights; the frozen programs
    agree to 1e-5 of the largest logit."""
    (jm, js, jl), (pm, ps, pl) = _both(_qat_mlp)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js)
    xs = _rand(16, 12, seed=3)
    jexe.run(jm, feed={"x": xs}, fetch_list=[jl])
    jscope, pscope = jfluid.global_scope(), fluid.global_scope()
    for n in jscope.keys():
        pscope.set(n, np.array(jscope[n]))
    place = {jfluid: jfluid.CPUPlace(), fluid: fluid.CPUPlace()}
    for fl, main, scope in ((jfluid, jm, jscope), (fluid, pm, pscope)):
        fl.contrib.slim.quantization.QuantizationFreezePass(
            scope, place[fl], weight_bits=bits,
            activation_bits=bits).apply(main)
        fl.contrib.slim.quantization.ConvertToInt8Pass(
            scope, place[fl]).apply(main)
    assert _json(pm) == _json(jm)
    assert [op.type for op in pm.global_block().ops].count(
        "quantized_mul") == 2
    for w in ("fc_0.w_0", "fc_1.w_0"):
        a, b = np.asarray(pscope[w]), np.asarray(jscope[w])
        assert a.dtype == b.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    got = fluid.Executor(fluid.CPUPlace()).run(pm, feed={"x": xs},
                                               fetch_list=[pl])[0]
    want = jexe.run(jm, feed={"x": xs}, fetch_list=[jl])[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


class _Graph:
    """What QuantizationStrategy reads of slim's GraphWrapper."""

    def __init__(self, program, in_nodes, out_nodes):
        self.program = program
        self.in_nodes = in_nodes
        self.out_nodes = out_nodes

    def clone(self, for_test=False):
        return _Graph(self.program.clone(for_test=for_test), self.in_nodes,
                      self.out_nodes)

    def var(self, name):
        class _V:
            _var = self.program.global_block().var(name)
        return _V()


class _Context:
    def __init__(self, graph, place, scope):
        self.optimize_graph = self.eval_graph = self.train_graph = graph
        self.place, self.scope, self.epoch_id = place, scope, 0
        self.store = {}

    def put(self, key, value):
        self.store[key] = value


def test_quantization_strategy_matches_the_jax_package(tmp_path):
    """The strategy's hooks on a small fc net in each package (a stand-in
    for the Compressor's context): the transform at the first epoch, one
    QAT forward, the freeze at the last. The port starts from the JAX
    package's parameters and takes its scale states after the forward:
    the same int8 program, and each saved model loads with its
    quantized_mul ops."""
    progs, snap = {}, {}

    def copy_in(scope, values):
        for n, v in values.items():
            scope.set(n, np.array(v))

    for fl in (jfluid, fluid):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.data("x", [None, 12], "float32")
            logits = fl.layers.fc(fl.layers.fc(x, 24, act="relu"), 4)
        main.random_seed = startup.random_seed = 5
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        scope = fl.global_scope()
        ctx = _Context(_Graph(main, {"x": "x"}, {"logits": logits.name}),
                       fl.CPUPlace(), scope)
        s = fl.contrib.slim.quantization.QuantizationStrategy(
            start_epoch=0, end_epoch=0,
            int8_model_save_path=str(tmp_path / fl.__name__))
        assert isinstance(s, fl.contrib.slim.core.Strategy)
        s.on_epoch_begin(ctx)
        if fl is fluid:
            copy_in(scope, snap["begin"])
        else:
            snap["begin"] = {n: np.array(v) for n, v in scope.items()}
        exe.run(main, feed={"x": _rand(8, 12, seed=2)},
                fetch_list=[logits])
        if fl is fluid:
            copy_in(scope, snap["run"])
        else:
            snap["run"] = {n: np.array(v) for n, v in scope.items()}
        s.on_epoch_end(ctx)
        progs[fl] = ctx.store["int8_program"]
        loaded = fl.io.load_inference_model(str(tmp_path / fl.__name__),
                                            exe)[0]
        assert "quantized_mul" in [op.type for op in
                                   loaded.global_block().ops]
    assert _json(progs[fluid]) == _json(progs[jfluid])


# ---------------------------------------------------------------------------
# post-training quantization in both packages
# ---------------------------------------------------------------------------
KL_SAMPLES = {
    "half_normal": lambda r: np.abs(r.standard_normal(262144)),
    "relu": lambda r: np.maximum(r.standard_normal(262144), 0),
    "heavy_tail": lambda r: np.abs(r.standard_cauchy(100000)),
    "large": lambda r: r.exponential(size=70000) * 1e3,
    "zeros": lambda r: np.zeros(1000),
    "mostly_zeros": lambda r: np.concatenate([np.zeros(50000),
                                              r.uniform(0, 5, 37)]),
    "fewer_than_the_bins": lambda r: np.abs(r.standard_normal(130)),
}


@pytest.mark.parametrize("case", sorted(KL_SAMPLES))
def test_kl_threshold_is_the_jax_package_s_bit_for_bit(case):
    from paddle_tpu.fluid.contrib.slim.quantization import (
        post_training_quantization as jptq)
    from paddle_tpu_torch.fluid.contrib.slim.quantization import (
        post_training_quantization as pptq)

    samples = KL_SAMPLES[case](np.random.default_rng(0)).astype(np.float32)
    assert pptq._kl_threshold(samples) == jptq._kl_threshold(samples)


def _strip_scales(prog):
    doc = _json(prog)
    scales = []
    for block in doc["blocks"]:
        for op in block["ops"]:
            if "act_scale" in op.get("attrs", {}):
                scales.append(op["attrs"].pop("act_scale"))
    return doc, scales


def _ptq_both(model_dir, gen, batch_size, batch_nums, feed_name, feed):
    """PTQ (KL) of the saved fp32 model in each package, each saved and
    loaded back; the quantized programs, the saved int8 params and the
    loaded programs' logits on `feed`, per package."""
    out = {}
    for fl in (jfluid, fluid):
        exe = fl.Executor(fl.CPUPlace())
        with fl.scope_guard(fl.Scope()):
            ptq = fl.contrib.slim.quantization.PostTrainingQuantization(
                executor=exe, sample_generator=gen, model_dir=model_dir,
                batch_size=batch_size, batch_nums=batch_nums, algo="KL")
            qprog = ptq.quantize()
            qdir = model_dir + "_int8_" + fl.__name__
            ptq.save_quantized_model(qdir)
        with fl.scope_guard(fl.Scope()):
            prog, _, fetches = fl.io.load_inference_model(qdir, exe)
            logits = exe.run(prog, feed={feed_name: feed},
                             fetch_list=fetches)[0]
        out[fl] = (qprog, np.load(os.path.join(qdir, "__params__.npz")),
                   logits, qdir)
    return out


def _assert_same_quantized_models(out):
    (jprog, jparams, _, _), (pprog, pparams, _, _) = out[jfluid], out[fluid]
    jdoc, jscales = _strip_scales(jprog)
    pdoc, pscales = _strip_scales(pprog)
    assert pdoc == jdoc and len(pscales) == len(jscales) > 0
    np.testing.assert_allclose(pscales, jscales, rtol=TOL, atol=0)
    assert sorted(pparams.files) == sorted(jparams.files)
    for n in jparams.files:
        assert pparams[n].dtype == jparams[n].dtype, n
        np.testing.assert_array_equal(pparams[n], jparams[n], err_msg=n)
    assert any(jparams[n].dtype == np.int8 for n in jparams.files)


def test_ptq_of_the_example_mlp_matches_the_jax_package(tmp_path):
    """examples/quantize_int8.py's MLP, trained in the JAX package as the
    example trains it (fewer steps), then PTQ in both packages."""
    D, H, C = 20, 64, 5
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((512, D)).astype("float32")
    ys = np.argmax(xs[:, :C], axis=1).astype("int64")[:, None]
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()):
        x = jfluid.data("x", shape=[None, D], dtype="float32")
        y = jfluid.data("y", shape=[None, 1], dtype="int64")
        h = jfluid.layers.fc(x, H, act="relu")
        logits = jfluid.layers.fc(h, C)
        loss = jfluid.layers.mean(
            jfluid.layers.softmax_with_cross_entropy(logits, y))
        test_prog = jfluid.default_main_program().clone(for_test=True)
        jfluid.optimizer.Adam(5e-3).minimize(loss)
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jfluid.default_startup_program())
        for i in range(0, 512, 128):
            exe.run(feed={"x": xs[i:i + 128], "y": ys[i:i + 128]},
                    fetch_list=[loss])
        model_dir = str(tmp_path / "fp32")
        jfluid.io.save_inference_model(model_dir, ["x"], [logits], exe,
                                       main_program=test_prog)
    out = _ptq_both(model_dir, lambda: ((xs[i],) for i in range(256)), 32,
                    8, "x", xs)
    _assert_same_quantized_models(out)
    assert [op.type for op in out[fluid][0].global_block().ops].count(
        "quantized_mul") == 2
    want, got = out[jfluid][2], out[fluid][2]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def quantized_inputs(prog):
    """(op, activation name) of each quantized op of `prog`."""
    return [(op, (op.input("X") or op.input("Input"))[0])
            for op in prog.global_block().ops
            if op.type in ("quantized_mul", "quantized_conv2d")]


def count_flips(prog, acts_a, acts_b):
    """Activation roundings that fell the other way: elements of each
    quantized op's input whose grid value differs between two runs
    (`acts_*` map the input names to each run's values), and all the
    elements quantized."""
    flips = total = 0
    for op, name in quantized_inputs(prog):
        qmax = 127.0 if op.attrs.get("quant_bits", 8) == 8 else 32767.0
        s = np.float32(op.attrs["act_scale"])
        qa = np.clip(np.round(acts_a[name] / s * qmax), -qmax, qmax)
        qb = np.clip(np.round(acts_b[name] / s * qmax), -qmax, qmax)
        flips += int((qa != qb).sum())
        total += qa.size
    return flips, total


def flip_bound(scale, spread, spread_flips, flips):
    """The logits bound for two runs of one int8 model whose f32
    activations differ in their last bits: a rounding that falls the
    other way moves one int8 input by a step, and the roundings
    downstream follow it, so the logits' distance grows with the flips.
    The run's own spread (its logits against a rerun whose input has one
    rounding forced the other way, ``flip_one``, which sets off
    `spread_flips`) gives the distance such a cascade makes: 3x that
    spread for each spread's worth of flips, plus 1e-5 of the largest
    logit for the f32 ops between the quantized ones."""
    return 3.0 * spread * max(1.0, flips / max(spread_flips, 1)) \
        + 1e-5 * scale


def flip_one(x, act_scale, bits=8):
    """`x` with the one element nearest a rounding boundary of its
    quantization grid mirrored across that boundary, so that it alone
    rounds the other way."""
    qmax = 127.0 if bits == 8 else 32767.0
    s = np.float32(act_scale)
    g = x.astype(np.float64) / s * qmax
    i = int(np.argmin(np.abs(g - np.floor(g) - 0.5)))
    out = x.copy().reshape(-1)
    out[i] = np.float32((2 * np.floor(g.reshape(-1)[i]) + 1
                         - g.reshape(-1)[i]) * s / qmax)
    return out.reshape(x.shape)


def test_ptq_of_a_resnet18_matches_the_jax_package(tmp_path):
    """ResNet-18 (models/resnet.py, 10 classes, 32x32), initialised by
    the JAX package's startup and saved as an fp32 inference model: PTQ
    over 4 batches of 8 in both packages. Then both packages serve the
    JAX package's int8 model on 16 other images: their logits within
    ``flip_bound`` of the flips between them, against the port's own
    spread when one rounding of the image falls the other way."""
    from paddle_tpu.models import resnet as jresnet

    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        vs = jresnet.build_resnet_train(depth=18, class_num=10,
                                        image_size=32)
    test_prog = main.clone(for_test=True)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    model_dir = str(tmp_path / "fp32")
    jfluid.io.save_inference_model(model_dir, ["image"], [vs["logits"]],
                                   exe, main_program=test_prog)
    imgs = np.random.default_rng(0).standard_normal(
        (48, 3, 32, 32)).astype(np.float32)
    out = _ptq_both(model_dir, lambda: ((imgs[i],) for i in range(32)), 8,
                    4, "image", imgs[32:])
    _assert_same_quantized_models(out)
    types = [op.type for op in out[fluid][0].global_block().ops]
    assert types.count("quantized_conv2d") == 20
    assert types.count("quantized_mul") == 1

    # one int8 model (the JAX package's) served by both, and by the port
    # again with one rounding of the image forced the other way
    qdir = out[jfluid][3]
    runs = []
    for fl, forced in ((jfluid, False), (fluid, False), (fluid, True)):
        exe = fl.Executor(fl.CPUPlace())
        with fl.scope_guard(fl.Scope()):
            prog, _, fetches = fl.io.load_inference_model(qdir, exe)
            ops = quantized_inputs(prog)
            feed = imgs[32:]
            if forced:
                assert ops[0][1] == "image"
                feed = flip_one(feed, ops[0][0].attrs["act_scale"])
            block = prog.global_block()
            vals = exe.run(prog, feed={"image": feed},
                           fetch_list=fetches + [block.var(n)
                                                 for _, n in ops])
        runs.append((vals[0], dict(zip([n for _, n in ops], vals[1:]))))
    (want, jacts), (got, pacts), (forced, facts) = runs
    flips, total = count_flips(prog, pacts, jacts)
    spread_flips, _ = count_flips(prog, pacts, facts)
    spread = float(np.abs(forced - got).max())
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    bound = flip_bound(scale, spread, spread_flips, flips)
    assert err <= bound, (err, bound, flips, total, spread, spread_flips)
    assert spread_flips > 0 and flips < 0.02 * total


def test_slim_exports_every_name_of_the_jax_package_s():
    """Every name each slim module of the JAX package exports is in the
    port's module; an unknown name raises AttributeError; the mkldnn and
    mobile shims raise, naming what they stand for."""
    slim = fluid.contrib.slim
    for mod in ("", ".core", ".graph", ".prune", ".distillation",
                ".searcher", ".nas", ".quantization"):
        jmod = importlib.import_module("paddle_tpu.fluid.contrib.slim" + mod)
        pmod = importlib.import_module(
            "paddle_tpu_torch.fluid.contrib.slim" + mod)
        for name in getattr(jmod, "__all__", [n for n in dir(jmod)
                                              if not n.startswith("_")]):
            assert getattr(pmod, name) is not None, (mod, name)
    for name in ("Compressor", "ConfigFactory", "Context", "GraphWrapper",
                 "prune", "distillation", "searcher", "nas", "quantization"):
        assert getattr(slim, name) is not None, name
    assert slim.core.Compressor is slim.Compressor
    with pytest.raises(AttributeError):
        slim.no_such_name
    from paddle_tpu_torch.fluid.contrib.slim.quantization import (
        mkldnn_post_training_strategy, quantization_mkldnn_pass)

    for mod in (mkldnn_post_training_strategy, quantization_mkldnn_pass):
        with pytest.raises(NotImplementedError, match="mkldnn"):
            mod.MKLDNNPostTrainingQuantStrategy
    with pytest.raises(NotImplementedError, match="mobile"):
        slim.quantization.TransformForMobilePass()


def test_the_port_registers_305_op_types():
    from paddle_tpu_torch.ops.registry import LOWERINGS
    import paddle_tpu.ops.registry as jreg

    new = {"fake_quantize_dequantize_abs_max",
           "fake_channel_wise_quantize_dequantize_abs_max",
           "fake_quantize_dequantize_moving_average_abs_max",
           "quantized_mul", "quantized_conv2d"}
    assert new <= set(LOWERINGS) and new <= set(jreg.LOWERINGS)
    assert len(LOWERINGS) == 305


# ---------------------------------------------------------------------------
# the JAX package's own quantization tests, on the port
# ---------------------------------------------------------------------------
def _reference_module(name):
    """tests/<name>.py loaded afresh, its fluid bound to the port's."""
    path = os.path.join(REPO, "tests", name + ".py")
    spec = importlib.util.spec_from_file_location("_on_port_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fluid = _CpuFluid("fluid")
    mod.framework = pt_framework
    mod.unique_name = pt_unique_name
    mod.layers = fluid.layers
    mod.quant = fluid.contrib.quant
    return mod


@pytest.fixture
def _port_modules(monkeypatch):
    """The modules the reference tests import in their bodies, as the
    port's, for the call."""
    import paddle_tpu_torch.fluid.contrib.quantize as pq
    import paddle_tpu_torch.fluid.contrib.slim.quantization as psq

    monkeypatch.setitem(sys.modules, "paddle_tpu.fluid.contrib.quant",
                        fluid.contrib.quant)
    monkeypatch.setitem(sys.modules,
                        "paddle_tpu.fluid.contrib.slim.quantization", psq)
    monkeypatch.setitem(sys.modules, "paddle_tpu.fluid.contrib.quantize", pq)
    monkeypatch.setattr(jax_executor, "global_scope",
                        pt_executor.global_scope)


QUANT_TESTS = ("test_fake_qdq_abs_max_numeric", "test_fake_qdq_ste_gradient",
               "test_transform_pass_inserts_fake_quant",
               "test_qat_training_converges_and_updates_scale",
               "test_transform_quantizes_sub_blocks")
SLIM_FRAMEWORK_TESTS = ("test_qat_freeze_convert_int8_accuracy",
                        "test_post_training_quantization",
                        "test_post_training_quantization_in_memory_program",
                        "test_quantize_transpiler_facade")


@pytest.mark.parametrize("test", QUANT_TESTS)
def test_reference_quant_test_passes_on_the_port(test, _port_modules):
    getattr(_reference_module("test_quant"), test)()


@pytest.mark.parametrize("test", SLIM_FRAMEWORK_TESTS)
def test_reference_slim_quantization_test_passes_on_the_port(
        test, _port_modules, tmp_path):
    fn = getattr(_reference_module("test_slim_framework"), test)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def test_reference_slim_reexport_test_passes_on_the_port(_port_modules):
    _reference_module("test_slim").test_slim_quantization_reexport()
