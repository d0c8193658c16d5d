"""Wide&Deep CTR in the port against the JAX package, on the CPU.

- The four ops the model brings (sigmoid, clip, log_loss, auc) get the same
  numpy inputs and attrs as the JAX lowerings. Forward values within 1e-6
  (f32 on both sides; sigmoid and the logs are computed by each library's
  own kernels, so the last bit may differ), gradients through jax.vjp and
  torch.autograd within 1e-6. ``clip``'s gradient follows jax, not
  ``torch.clamp``: 1 strictly inside the bounds, 0.5 at either bound, 0
  outside (compared exactly). ``auc``'s statistics equal the reference's
  exactly over several updates (integer counts in f32), its value within
  1e-6.
- Program JSON parity of bench.py's ``build_wide_deep()`` + ``Adam(1e-3)``
  (main and startup), and of the small model the other tests train.
- 5 Adam steps of the small model (vocab 1000, hidden [32, 32]) on
  JAX-initialised parameters carried by ``params_from_numpy``, a new batch
  each step: losses within 1e-5 relative and gradients within
  1e-5·max|grad| of each parameter's at every step (measured: 1.2e-7 and
  1.4e-6), parameters within 1e-5·max|param| after the 5 steps (measured
  2.5e-6). ``auc``'s statistics: the same totals, and the per-bin counts
  within one sample moved to a neighbouring bin (a probability one ulp
  apart on either side of a bin edge lands in the next bin; measured one
  such move), the AUC within 1e-5.
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
from paddle_tpu.models import wide_deep as jwd
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import wide_deep as wd
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

OP_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5
AUC_TOL = 1e-5
SMALL = dict(sparse_vocab=1000, hidden=[32, 32])


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


def _port(op_type, ins, attrs):
    return pt_lowering(op_type)(
        LowerContext(torch.device("cpu")),
        {k: [torch.as_tensor(np.ascontiguousarray(a)) for a in v]
         for k, v in ins.items()}, dict(attrs))


def _jax(op_type, ins, attrs):
    return jax_lowering(op_type)(
        JaxLowerContext(platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))


def _grads(op_type, ins, attrs, wrt, out_slot, cot):
    """d<out_slot, cot>/d ins[wrt][0] in both packages (numpy)."""
    x = torch.tensor(ins[wrt][0], requires_grad=True)
    tins = {k: [torch.as_tensor(np.ascontiguousarray(a)) for a in v]
            for k, v in ins.items()}
    tins[wrt] = [x]
    out = pt_lowering(op_type)(LowerContext(torch.device("cpu")), tins,
                               dict(attrs))[out_slot][0]
    got, = torch.autograd.grad(out, x, grad_outputs=torch.as_tensor(cot))

    def f(v):
        jins = {k: [jnp.asarray(a) for a in vs] for k, vs in ins.items()}
        jins[wrt] = [v]
        return jax_lowering(op_type)(JaxLowerContext(platform="cpu"), jins,
                                     dict(attrs))[out_slot][0]

    _, vjp = jax.vjp(f, jnp.asarray(ins[wrt][0]))
    want, = vjp(jnp.asarray(cot))
    return got.numpy(), np.asarray(want)


def _close(a, w, tol=OP_TOL):
    w = np.asarray(w)
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    assert a.shape == w.shape and a.dtype == w.dtype, (a.shape, w.shape,
                                                       a.dtype, w.dtype)
    np.testing.assert_allclose(a, w, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the four ops
# ---------------------------------------------------------------------------
def test_every_new_op_has_a_port_lowering():
    for op in ("sigmoid", "clip", "log_loss", "auc"):
        assert callable(pt_lowering(op))


def test_sigmoid():
    x = np.concatenate([_rand(4, 5) * 4, [[-30.0, -17.0, 0.0, 17.0, 30.0]]]
                       ).astype(np.float32)
    _close(_port("sigmoid", {"X": [x]}, {})["Out"][0],
           _jax("sigmoid", {"X": [x]}, {})["Out"][0])
    got, want = _grads("sigmoid", {"X": [x]}, {}, "X", "Out",
                       _rand(5, 5, seed=1))
    _close(got, want)


@pytest.mark.parametrize("bounds", ["attrs", "inputs"])
def test_clip_values_and_gradient_at_the_bounds(bounds):
    lo, hi = 1e-7, 1.0 - 1e-7
    x = np.array([[-1.0, 0.0, lo, 0.25, 0.5],
                  [hi, 1.0, 2.0, np.float32(lo), np.float32(hi)]],
                 np.float32)
    if bounds == "attrs":
        ins, attrs = {"X": [x]}, {"min": lo, "max": hi}
    else:
        ins = {"X": [x], "Min": [np.array([lo], np.float32)],
               "Max": [np.array([hi], np.float32)]}
        attrs = {}
    _close(_port("clip", ins, attrs)["Out"][0],
           _jax("clip", ins, attrs)["Out"][0], tol=0)
    cot = np.ones_like(x)
    got, want = _grads("clip", ins, attrs, "X", "Out", cot)
    np.testing.assert_array_equal(got, want)
    # jax's tie rule: 1 inside, 0.5 at a bound, 0 outside
    lo32, hi32 = np.float32(lo), np.float32(hi)
    expect = np.where((x > lo32) & (x < hi32), 1.0,
                      np.where((x == lo32) | (x == hi32), 0.5, 0.0))
    np.testing.assert_array_equal(got, expect.astype(np.float32))
    assert (got == 0.5).sum() == 4


def test_clip_of_a_saturated_sigmoid_gets_half_the_gradient():
    """prob = sigmoid(40) rounds to 1.0 in f32, clipped to 1 - 1e-7 (the
    f32 value just below 1): the gradient reaching prob is half, as in jax;
    ``torch.clamp`` would pass it whole."""
    hi = 1.0 - 1e-7
    prob = torch.sigmoid(torch.tensor([40.0]))
    x = np.array([float(np.float32(hi))], np.float32)
    got, want = _grads("clip", {"X": [x]}, {"min": 1e-7, "max": hi}, "X",
                       "Out", np.ones(1, np.float32))
    assert float(prob) == 1.0 and got[0] == want[0] == 0.5
    t = torch.tensor(x, requires_grad=True)
    torch.clamp(t, 1e-7, hi).sum().backward()
    assert float(t.grad[0]) == 1.0          # what the port must not do


@pytest.mark.parametrize("eps", [1e-4, 1e-7])
def test_log_loss(eps):
    rng = np.random.default_rng(3)
    pred = rng.uniform(1e-7, 1 - 1e-7, size=(16, 1)).astype(np.float32)
    label = rng.integers(0, 2, size=(16, 1)).astype(np.float32)
    ins, attrs = {"Predicted": [pred], "Labels": [label]}, {"epsilon": eps}
    _close(_port("log_loss", ins, attrs)["Loss"][0],
           _jax("log_loss", ins, attrs)["Loss"][0])
    got, want = _grads("log_loss", ins, attrs, "Predicted", "Loss",
                       _rand(16, 1, seed=4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_log_loss_default_epsilon():
    pred = np.array([[0.0], [1.0], [0.3]], np.float32)
    label = np.array([[0.0], [1.0], [1.0]], np.float32)
    ins = {"Predicted": [pred], "Labels": [label]}
    _close(_port("log_loss", ins, {})["Loss"][0],
           _jax("log_loss", ins, {})["Loss"][0])


@pytest.mark.parametrize("num_thresholds", [4095, 200])
def test_auc_counts_and_value_over_several_updates(num_thresholds):
    rng = np.random.default_rng(num_thresholds)
    pos = np.zeros(num_thresholds + 1, np.float32)
    neg = np.zeros(num_thresholds + 1, np.float32)
    jpos, jneg = pos, neg
    attrs = {"curve": "ROC", "num_thresholds": num_thresholds}
    for step in range(4):
        p = rng.uniform(size=(64, 1)).astype(np.float32)
        # the bounds and bin edges land in their bins (0 and 1 included)
        p[:4, 0] = [0.0, 1.0, 0.5, 3.0 / num_thresholds]
        label = rng.integers(0, 2, size=(64, 1)).astype(np.int64)
        predict = np.concatenate([1 - p, p], axis=1)
        got = _port("auc", {"Predict": [predict], "Label": [label],
                            "StatPos": [pos], "StatNeg": [neg]}, attrs)
        want = _jax("auc", {"Predict": [predict], "Label": [label],
                            "StatPos": [jpos], "StatNeg": [jneg]}, attrs)
        pos, neg = got["StatPosOut"][0].numpy(), got["StatNegOut"][0].numpy()
        jpos, jneg = (np.asarray(want["StatPosOut"][0]),
                      np.asarray(want["StatNegOut"][0]))
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(neg, jneg)
        assert pos.sum() + neg.sum() == 64 * (step + 1)
        _close(got["AUC"][0], want["AUC"][0])
        assert got["AUC"][0].dtype == torch.float32       # see ROADMAP.md


def test_auc_of_a_perfect_ranking_is_one():
    p = np.linspace(0.01, 0.99, 32, dtype=np.float32)[:, None]
    label = (p > 0.5).astype(np.int64)
    got = _port("auc", {"Predict": [p], "Label": [label],
                        "StatPos": [np.zeros(4096, np.float32)],
                        "StatNeg": [np.zeros(4096, np.float32)]},
                {"num_thresholds": 4095})
    assert abs(float(got["AUC"][0]) - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _build(fl, un, pkg, seed=7, **kw):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = seed
    with fl.program_guard(main, start):
        vs = pkg.build_wide_deep(**kw)
        fl.optimizer.Adam(1e-3).minimize(vs["loss"])
    return main, start, vs


@pytest.mark.parametrize("size", ["bench", "small"])
def test_program_parity(size):
    kw = {} if size == "bench" else SMALL
    jmain, jstart, _ = _build(jfluid, jax_unique_name, jwd, **kw)
    pmain, pstart, _ = _build(fluid, pt_unique_name, wd, **kw)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    types = sorted({op.type for op in pmain.global_block().ops})
    assert types == [
        "adam", "auc", "backward", "cast", "clip", "concat",
        "elementwise_add", "elementwise_sub",
        "fill_constant_batch_size_like", "log_loss", "lookup_table_v2",
        "mean", "mul", "reduce_sum", "relu", "reshape2", "sigmoid",
        "unsqueeze2"]
    assert sorted({op.type for op in pstart.global_block().ops}) == [
        "fill_constant", "uniform_random"]
    names = {p.name for p in pmain.all_parameters()}
    assert {"ctr_emb", "ctr_wide_emb", "wide_fc.w", "head.w",
            "head.b"} <= names


def test_wd_tp_rules_waits_for_the_parallel_slice():
    """The rules are the JAX package's (the name is kept from when they
    waited for the parallel slice)."""
    assert [(p, tuple(s)) for p, s in wd.wd_tp_rules()] == [
        (p, tuple(s)) for p, s in jwd.wd_tp_rules()]


def test_synthetic_batch_matches_the_reference():
    for a, w in zip(wd.synthetic_ctr_batch(16, seed=3),
                    jwd.synthetic_ctr_batch(16, seed=3)):
        np.testing.assert_array_equal(a, w)


def _stats_names(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable and v.name.startswith("auc_"))


def assert_auc_stats_close(got, want):
    """The same totals; per-bin counts within one sample moved to a
    neighbouring bin (the running difference of the histograms stays
    within 1)."""
    assert got.sum() == want.sum()
    assert np.abs(np.cumsum(got - want)).max() <= 1


def test_adam_steps_match_jax():
    jmain, jstart, jvs = _build(jfluid, jax_unique_name, jwd, **SMALL)
    pmain, _, pvs = _build(fluid, pt_unique_name, wd, **SMALL)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in persist},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters() if p.trainable)
    grads = [p + "@GRAD" for p in params]
    for step in range(5):
        d, s, lab = wd.synthetic_ctr_batch(64, sparse_vocab=1000, seed=step)
        feed = {"dense": d, "sparse": s, "ctr_label": lab}
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"], jvs["auc"]] + grads)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"], pvs["auc"]] + grads)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        assert abs(float(pout[1]) - float(np.asarray(jout[1]))) <= AUC_TOL
        for name, a, w in zip(params, pout[2:], jout[2:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            assert float(np.abs(a - w).max()) <= GRAD_TOL * float(
                np.abs(w).max()), (step, name)
    for name in params:
        a, w = scope[name].numpy(), np.asarray(jscope[name])
        assert float(np.abs(a - w).max()) <= PARAM_TOL * float(
            np.abs(w).max()), name
    for name in _stats_names(pmain):
        assert_auc_stats_close(scope[name].numpy(), np.asarray(jscope[name]))
