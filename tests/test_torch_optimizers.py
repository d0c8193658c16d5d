"""The training surface's ops and optimizers against the JAX package, on
the CPU.

- The op lowerings the learning-rate schedules, the clips and the
  regularizers need (elementwise_pow, reduce_mean, sum, clip_by_norm,
  sign, pow, squared_l2_norm, exp, sqrt, square, floor, ceil, cos), each
  on the same numpy inputs and attrs as the JAX lowering: within 1e-6
  relative (f32; the rounding ones and sign exact).
- The ten update ops (dgc_momentum, lars_momentum, adagrad,
  decayed_adagrad, adadelta, adamax, rmsprop, ftrl, lamb, dpsgd), each
  against the JAX lowering: within 1e-6 of max|out| (f32 elementwise, the
  norms summed in another order). dpsgd's noise comes from the run's
  generator, so it is exact at sigma = 0 and held by the mean and
  variance of its noise at sigma > 0. dgc_momentum's quantile is
  ``jnp.quantile``'s, bit for bit, and works above 2^24 elements, where
  ``torch.quantile`` refuses.
- Each of the ten optimizers and the four wrappers (ModelAverage,
  ExponentialMovingAverage, LookaheadOptimizer, RecomputeOptimizer) on a
  small fc model: the same Program JSON as the JAX package's, then 5
  steps in both packages from the JAX startup's parameters on the same
  feeds: losses within 1e-5 relative, and every parameter and
  accumulator within 1e-5 of its max|value| (ModelAverage's and EMA's
  applied parameters too, and the trained ones back after restore).
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
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

OP_TOL = 1e-6           # relative, of max|out|
TRAIN_TOL = 1e-5
STEPS = 5


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


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _run_both(op_type, ins, attrs, seed=0):
    """The port's and the JAX package's lowering of `op_type` on the same
    numpy inputs; returns ({slot: [np]}, {slot: [np]})."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    got = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=gen),
        {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
         for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(seed), platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, dict(attrs))
    return ({k: [t.numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()})


def _assert_close(got, want, tol=OP_TOL, slots=None):
    for slot in slots or want:
        assert slot in got, slot
        for a, w in zip(got[slot], want[slot]):
            assert a.shape == w.shape, (slot, a.shape, w.shape)
            assert a.dtype == w.dtype, (slot, a.dtype, w.dtype)
            scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
            np.testing.assert_allclose(a, w, rtol=0, atol=tol * scale,
                                       err_msg=slot)


# ---------------------------------------------------------------------------
# the op lowerings of the schedules, clips and regularizers
# ---------------------------------------------------------------------------
_POS = np.abs(_rand(4, 6, seed=1)) + 0.1
MATH_CASES = {
    "elementwise_pow": ({"X": [_POS], "Y": [_rand(4, 6, seed=2)]}, {}),
    "elementwise_pow-bcast": ({"X": [_POS], "Y": [np.array(
        [0.5], np.float32)]}, {"axis": -1}),
    "reduce_mean-all": ({"X": [_rand(4, 6, 5)]}, {"dim": None,
                                                  "reduce_all": True}),
    "reduce_mean-dim": ({"X": [_rand(4, 6, 5)]}, {"dim": [1, -1],
                                                  "keep_dim": True,
                                                  "reduce_all": False}),
    "sum": ({"X": [_rand(3, 4, seed=i) for i in range(4)]}, {}),
    "clip_by_norm-clipped": ({"X": [_rand(5, 7)]}, {"max_norm": 1.0}),
    "clip_by_norm-kept": ({"X": [_rand(5, 7) * 1e-3]}, {"max_norm": 1.0}),
    "sign": ({"X": [np.array([-2.0, 0.0, 3.0, -0.0], np.float32)]}, {}),
    "pow": ({"X": [_POS]}, {"factor": 2.5}),
    "pow-tensor": ({"X": [_POS], "FactorTensor": [np.array(
        [1.5], np.float32)]}, {}),
    "squared_l2_norm": ({"X": [_rand(8, 9)]}, {}),
    "exp": ({"X": [_rand(4, 6)]}, {}),
    "sqrt": ({"X": [_POS]}, {}),
    "square": ({"X": [_rand(4, 6)]}, {}),
    "floor": ({"X": [_rand(4, 6) * 5]}, {}),
    "ceil": ({"X": [_rand(4, 6) * 5]}, {}),
    "cos": ({"X": [_rand(4, 6) * 3]}, {}),
}


@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math_op_matches_jax(case):
    ins, attrs = MATH_CASES[case]
    got, want = _run_both(case.split("-")[0], ins, attrs)
    _assert_close(got, want)


# ---------------------------------------------------------------------------
# the ten update ops
# ---------------------------------------------------------------------------
def _update_ins(op, shape=(6, 5), seed=0):
    p, g = _rand(*shape, seed=seed, scale=0.5), _rand(*shape, seed=seed + 1)

    def pos(k):
        return np.abs(_rand(*shape, seed=seed + k)) * 0.1

    def one(v):
        return np.array([v], np.float32)

    return {
        "dgc_momentum": ({"Param": [p], "Grad": [g], "U": [pos(2)],
                          "V": [_rand(*shape, seed=seed + 3)],
                          "CurrentStep": [one(4.0)],
                          "LearningRate": [one(0.1)]},
                         {"mu": 0.9, "rampup_begin_step": 2,
                          "rampup_step": 4, "sparsity": [0.5, 0.75, 0.9],
                          "local_grad_clip_norm": 2.0}),
        "lars_momentum": ({"Param": [p], "Grad": [g], "Velocity": [pos(2)],
                           "LearningRate": [one(0.1)]},
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "adagrad": ({"Param": [p], "Grad": [g], "Moment": [pos(2)],
                     "LearningRate": [one(0.1)]}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({"Param": [p], "Grad": [g], "Moment": [pos(2)],
                             "LearningRate": [one(0.1)]},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ({"Param": [p], "Grad": [g], "AvgSquaredGrad": [pos(2)],
                      "AvgSquaredUpdate": [pos(3)]},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "adamax": ({"Param": [p], "Grad": [g], "Moment": [pos(2)],
                    "InfNorm": [pos(3)], "Beta1Pow": [one(0.9 ** 3)],
                    "LearningRate": [one(0.01)]},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "rmsprop": ({"Param": [p], "Grad": [g], "MeanSquare": [pos(2)],
                     "Moment": [pos(3)], "MeanGrad": [pos(4) * 0.1],
                     "LearningRate": [one(0.01)]},
                    {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                     "centered": True}),
        "ftrl": ({"Param": [p], "Grad": [g], "SquaredAccumulator": [pos(2)],
                  "LinearAccumulator": [_rand(*shape, seed=seed + 3)],
                  "LearningRate": [one(0.1)]},
                 {"l1": 0.05, "l2": 0.01, "lr_power": -0.5}),
        "lamb": ({"Param": [p], "Grad": [g], "Moment1": [pos(2)],
                  "Moment2": [pos(3)], "Beta1Pow": [one(0.9 ** 2)],
                  "Beta2Pow": [one(0.999 ** 2)],
                  "LearningRate": [one(0.01)]},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                  "weight_decay": 0.01}),
        "dpsgd": ({"Param": [p], "Grad": [g], "LearningRate": [one(0.1)]},
                  {"clip": 1.0, "batch_size": 16.0, "sigma": 0.0}),
    }[op]


UPDATE_OPS = ("dgc_momentum", "lars_momentum", "adagrad", "decayed_adagrad",
              "adadelta", "adamax", "rmsprop", "ftrl", "lamb", "dpsgd")


@pytest.mark.parametrize("op", UPDATE_OPS)
def test_update_op_matches_jax(op):
    ins, attrs = _update_ins(op)
    got, want = _run_both(op, ins, attrs)
    assert set(got) == set(want), op
    _assert_close(got, want)


@pytest.mark.parametrize("variant", ["before-rampup", "plain-rmsprop",
                                     "lamb-zero-param", "lars-zero-grad"])
def test_update_op_branches_match_jax(variant):
    """The other side of each branch: dgc before its rampup (plain
    momentum), rmsprop uncentered (no MeanGradOut), lamb's and lars's
    norm guards (a zero parameter, a zero gradient)."""
    op = {"before-rampup": "dgc_momentum", "plain-rmsprop": "rmsprop",
          "lamb-zero-param": "lamb", "lars-zero-grad": "lars_momentum"}[
              variant]
    ins, attrs = _update_ins(op)
    if variant == "before-rampup":
        ins["CurrentStep"] = [np.array([1.0], np.float32)]
    elif variant == "plain-rmsprop":
        attrs["centered"] = False
    elif variant == "lamb-zero-param":
        ins["Param"] = [np.zeros_like(ins["Param"][0])]
    else:
        ins["Grad"] = [np.zeros_like(ins["Grad"][0])]
    got, want = _run_both(op, ins, attrs)
    assert set(got) == set(want), op
    _assert_close(got, want)


def test_dpsgd_noise_by_its_moments():
    """sigma > 0: the update is p - lr·(clip(g) + N(0, 1)·sigma·clip /
    batch_size). Over 200,000 elements the noise's mean is within 4
    standard errors of 0 and its standard deviation within 1% of
    sigma·clip/batch_size in both packages, and the clipped gradient part
    equals the sigma = 0 update."""
    shape = (400, 500)
    ins, attrs = _update_ins("dpsgd", shape)
    attrs.update(sigma=2.0, clip=1.0, batch_size=16.0)
    got, want = _run_both("dpsgd", ins, attrs)
    exact, _ = _run_both("dpsgd", ins, dict(attrs, sigma=0.0))
    lr = float(ins["LearningRate"][0][0])
    std = attrs["sigma"] * attrs["clip"] / attrs["batch_size"]
    for res in (got, want):
        noise = (exact["ParamOut"][0] - res["ParamOut"][0]) / lr
        assert abs(noise.mean()) < 4 * std / np.sqrt(noise.size)
        assert abs(noise.std() / std - 1) < 1e-2


def _quantile_f32(a, q):
    """jnp.quantile's linear rule in f32 arithmetic, its two order
    statistics read with np.partition."""
    q = np.float32(q)
    pos = q * (np.float32(a.size) - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = pos - lo
    part = np.partition(a, (int(lo), int(hi)))
    return part[int(lo)] * (np.float32(1) - hw) + part[int(hi)] * hw


def test_dgc_quantile_matches_jnp_quantile():
    """dgc's threshold is jnp.quantile's linear rule: equal to
    jnp.quantile's value, bit for bit, at 100,003 elements; above 2^24
    elements, where torch.quantile raises, equal to the same rule in f32
    over np.partition's order statistics (which the first half holds to
    jnp.quantile)."""
    small = np.abs(_rand(100_003, seed=5))
    big = np.abs(_rand(2 ** 24 + 3, seed=6))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(big), 0.5)
    for q in (0.999, 0.75, 0.1):
        qt = torch.tensor(q, dtype=torch.float32)
        got = optimizer_ops._quantile(torch.from_numpy(small), qt)
        want = np.asarray(jnp.quantile(jnp.asarray(small), jnp.float32(q)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(_quantile_f32(small, q), want)
        got = optimizer_ops._quantile(torch.from_numpy(big), qt)
        np.testing.assert_array_equal(got.numpy(), _quantile_f32(big, q))


# ---------------------------------------------------------------------------
# the optimizers and wrappers, 5 steps of a small fc model
# ---------------------------------------------------------------------------
def _make_opt(fl, name):
    o = fl.optimizer
    return {
        "SGD": lambda: o.SGD(0.1),
        "Momentum": lambda: o.Momentum(0.1, 0.9, use_nesterov=True),
        "DGCMomentum": lambda: o.DGCMomentum(
            0.1, 0.9, rampup_begin_step=2, rampup_step=2,
            sparsity=[0.5, 0.9]),
        "LarsMomentum": lambda: o.LarsMomentum(0.5, 0.9),
        "Adagrad": lambda: o.Adagrad(0.1),
        "Adam": lambda: o.Adam(0.01),
        "Adamax": lambda: o.Adamax(0.01),
        "Dpsgd": lambda: o.Dpsgd(0.1, clip=1.0, batch_size=4.0, sigma=0.0),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(0.1),
        "Adadelta": lambda: o.Adadelta(1.0),
        "RMSProp": lambda: o.RMSProp(0.01, momentum=0.5, centered=True),
        "Ftrl": lambda: o.Ftrl(0.1, l1=1e-3, l2=1e-3),
        "Lamb": lambda: o.Lamb(0.01, exclude_from_weight_decay_fn=lambda
                               p: p.name.endswith(".b_0")),
    }[name]()


OPTIMIZERS = ("DGCMomentum", "LarsMomentum", "Adagrad", "Adamax", "Dpsgd",
              "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "Lamb")
WRAPPERS = ("ModelAverage", "ExponentialMovingAverage", "LookaheadOptimizer",
            "RecomputeOptimizer")


def _fc_program(fl, un, kind):
    """x (4, 8) -> fc 16 relu -> fc 1 -> mean(h²) under optimizer or
    wrapper `kind`; returns (main, startup, loss, wrapper or None)."""
    un.switch()
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 11
    wrap = None
    with fl.program_guard(main, startup):
        x = fl.data("x", [None, 8], dtype="float32")
        h1 = fl.layers.fc(x, 16, act="relu")
        h = fl.layers.fc(h1, 1)
        loss = fl.layers.mean(fl.layers.elementwise_mul(h, h))
        if kind in OPTIMIZERS:
            _make_opt(fl, kind).minimize(loss)
        elif kind == "LookaheadOptimizer":
            fl.optimizer.LookaheadOptimizer(
                _make_opt(fl, "SGD"), alpha=0.5, k=2).minimize(loss)
        elif kind == "RecomputeOptimizer":
            wrap = fl.optimizer.RecomputeOptimizer(_make_opt(fl, "Adam"))
            wrap._set_checkpoints([h1])
            wrap.minimize(loss)
        else:
            _make_opt(fl, "Momentum").minimize(loss)
            if kind == "ModelAverage":
                wrap = fl.optimizer.ModelAverage(
                    0.15, min_average_window=2, max_average_window=3)
            else:
                wrap = fl.optimizer.ExponentialMovingAverage(0.8)
                wrap.update()
    return main, startup, loss, wrap


def _feeds():
    rng = np.random.default_rng(3)
    return [{"x": rng.normal(size=(4, 8)).astype(np.float32)}
            for _ in range(STEPS)]


def _close(a, w, what):
    a, w = np.asarray(a, np.float32), np.asarray(w, np.float32)
    assert a.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(a - w).max()) <= TRAIN_TOL * scale, what


@pytest.mark.parametrize("kind", OPTIMIZERS + WRAPPERS)
def test_optimizer_trains_like_jax(kind):
    jmain, jstart, jloss, jwrap = _fc_program(jfluid, jax_unique_name, kind)
    pmain, pstart, ploss, pwrap = _fc_program(fluid, pt_unique_name, kind)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in pmain.global_block().vars.values()
               if v.persistable]
    init = {n: np.array(jscope[n]) for n in persist if n in jscope}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    for feed in _feeds():
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        pl, = exe.run(pmain, feed=feed, fetch_list=[ploss], scope=scope)
        assert np.isfinite(pl)
        assert abs(float(pl) - float(np.asarray(jl))) <= TRAIN_TOL * abs(
            float(np.asarray(jl))), kind
    params = [p.name for p in pmain.all_parameters()]
    for n in persist:
        _close(scope[n].numpy(), jscope[n], n)
    moved = [n for n in params if not np.array_equal(scope[n].numpy(),
                                                     init[n])]
    assert moved == params, kind
    if kind in ("ModelAverage", "ExponentialMovingAverage"):
        trained = {n: scope[n].clone() for n in params}
        with jfluid.scope_guard(jscope), jwrap.apply(jexe):
            japplied = {n: np.array(jscope[n]) for n in params}
        with fluid.scope_guard(scope), pwrap.apply(exe):
            for n in params:
                _close(scope[n].numpy(), japplied[n], n + " applied")
                assert not torch.equal(scope[n], trained[n]), n
        for n in params:
            assert torch.equal(scope[n], trained[n]), n + " restored"
        # need_restore=False keeps the applied values until restore()
        with fluid.scope_guard(scope):
            with pwrap.apply(exe, need_restore=False):
                pass
            _close(scope[params[0]].numpy(), japplied[params[0]],
                   "kept applied")
            pwrap.restore(exe)
        assert torch.equal(scope[params[0]], trained[params[0]])


def test_pipeline_and_dygraph_minimize_name_their_items():
    # PipelineOptimizer is ported: on a world of one rank its program
    # runs into the JAX package's refusal (one device per stage)
    from paddle_tpu_torch.fluid.lowering import OpLoweringError

    x = fluid.data("px", [None, 4], dtype="float32")
    h = fluid.layers.fc(x, 4, act="relu")
    loss = fluid.layers.reduce_mean(fluid.layers.fc(h, 1))
    fluid.optimizer.PipelineOptimizer(
        fluid.optimizer.SGD(0.1), cut_list=[h]).minimize(loss)
    assert fluid.default_main_program()._parallel_info["mode"] == "pipeline"
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    with pytest.raises(OpLoweringError, match="one device per stage"):
        exe.run(feed={"px": np.ones((2, 4), "float32")}, fetch_list=[loss])
    with pytest.raises(NotImplementedError, match="item 9"):
        fluid.optimizer.SGD(0.1).minimize(torch.zeros(()))
