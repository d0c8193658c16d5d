"""Learning-rate schedules, gradient clipping and regularizers of the port
against the JAX package, on the CPU.

- Each of the eight schedules (noam, exponential, natural_exp,
  inverse_time, polynomial, piecewise, cosine, linear warmup), with and
  without its ``staircase``/``cycle`` option: the same Program JSON as
  the JAX package's (the ``increment`` of ``@LR_DECAY_COUNTER@``
  prepended), and its value at each of 30 runs within 1e-6 relative of
  the JAX package's, or 1e-7 of the schedule's base rate where the value
  is near 0. Not bit for bit: XLA on the CPU fuses ``x·scale + bias``
  into one fused multiply-add, the port rounds the product first, so a
  value may differ in its last bit, and a polynomial decay at its end
  gives 0 where the JAX package gives 1 − 25·0.04 = 2.2e-8 of its rate
  (ROADMAP Queue 3).
- Each clip and regularizer on a small fc model trained 3 steps by SGD
  in both packages from the same parameters: the ``fluid.clip``
  attributes (by value, by norm, by global norm, set with
  ``set_gradient_clip``), the ``GradClip*`` classes passed as
  ``minimize(grad_clip=)``, L1Decay and L2Decay as the optimizer's
  regularization and as a ParamAttr's: the same Program JSON, losses
  within 1e-6 relative and parameters within 1e-6 of max|param|.
- ``dygraph_grad_clip`` on tensors against the JAX classes on arrays
  (1e-6).
- The LAMB recipe for BERT (Lamb, warmup + polynomial decay, global-norm
  clip, RecomputeOptimizer over each layer's output) builds the same
  Program JSON as the JAX package at bert_tiny.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import dygraph_grad_clip as jclip
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import dygraph_grad_clip as pclip
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import bert

LR_TOL = 1e-6
TOL = 1e-6


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


def _build(fl, un, fn):
    un.switch()
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 5
    with fl.program_guard(main, startup):
        out = fn(fl)
    return main, startup, out


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 8),
    "exponential": lambda L: L.exponential_decay(0.1, 7, 0.5),
    "exponential-staircase": lambda L: L.exponential_decay(0.1, 7, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 7, 0.3),
    "natural_exp-staircase": lambda L: L.natural_exp_decay(
        0.1, 7, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "inverse_time-staircase": lambda L: L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 20, 0.01, power=2.0),
    "polynomial-cycle": lambda L: L.polynomial_decay(0.1, 8, 0.01,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([4, 11, 20],
                                             [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 3, 10),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 6, 0.0, 0.1),
    "linear_warmup-decay": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-1, 25, 0.0), 10, 0.01, 0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    fn = SCHEDULES[name]
    jmain, jstart, jlr = _build(jfluid, jax_unique_name,
                                lambda fl: fn(fl.layers))
    pmain, pstart, plr = _build(fluid, pt_unique_name,
                                lambda fl: fn(fl.layers))
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    assert pmain.global_block().ops[0].type == "increment"
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    exe.run(pstart, scope=scope)
    got, want = [], []
    for _ in range(30):
        want.append(float(np.asarray(jexe.run(
            jmain, fetch_list=[jlr], scope=jscope)[0]).reshape(-1)[0]))
        got.append(float(exe.run(pmain, fetch_list=[plr],
                                 scope=scope)[0].reshape(-1)[0]))
    base = max(abs(v) for v in want)
    np.testing.assert_allclose(got, want, rtol=LR_TOL, atol=1e-7 * base)
    assert len(set(want)) > 3, want          # the schedule moves


# ---------------------------------------------------------------------------
# clips and regularizers
# ---------------------------------------------------------------------------
CLIPS = ("value", "norm", "global_norm", "grad_clip_value",
         "grad_clip_norm", "grad_clip_global_norm", "l1_decay", "l2_decay",
         "param_l2_decay", "global_norm_and_l1_decay")


def _clip_program(kind):
    def fn(fl):
        x = fl.data("x", [None, 6], dtype="float32")
        attr = None
        if kind == "param_l2_decay":
            attr = fl.ParamAttr(regularizer=fl.regularizer.L2Decay(0.05))
        h = fl.layers.fc(x, 5, act="relu", param_attr=attr)
        loss = fl.layers.mean(fl.layers.fc(h, 3))
        main = fl.default_main_program()
        c, grad_clip, reg = fl.clip, None, None
        if kind == "value":
            c.set_gradient_clip(c.GradientClipByValue(0.05), program=main)
        elif kind == "norm":
            c.set_gradient_clip(c.GradientClipByNorm(0.1), program=main)
        elif kind in ("global_norm", "global_norm_and_l1_decay"):
            c.set_gradient_clip(c.GradientClipByGlobalNorm(0.2),
                                program=main)
        elif kind == "grad_clip_value":
            grad_clip = c.GradClipByValue(-0.05, 0.05)
        elif kind == "grad_clip_norm":
            grad_clip = c.GradClipByNorm(0.1)
        elif kind == "grad_clip_global_norm":
            grad_clip = c.GradClipByGlobalNorm(0.2)
        if kind in ("l1_decay", "global_norm_and_l1_decay"):
            reg = fl.regularizer.L1Decay(0.05)
        elif kind == "l2_decay":
            reg = fl.regularizer.L2Decay(0.05)
        fl.optimizer.SGD(0.5, regularization=reg).minimize(
            loss, grad_clip=grad_clip)
        return loss
    return fn


@pytest.mark.parametrize("kind", CLIPS)
def test_clip_and_regularizer_train_like_jax(kind):
    jmain, jstart, jloss = _build(jfluid, jax_unique_name,
                                  _clip_program(kind))
    pmain, pstart, ploss = _build(fluid, pt_unique_name, _clip_program(kind))
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    params = [p.name for p in pmain.all_parameters()]
    init = {v.name: np.array(jscope[v.name])
            for v in pmain.global_block().vars.values() if v.persistable}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    rng = np.random.default_rng(1)
    for _ in range(3):
        feed = {"x": (rng.normal(size=(4, 6)) * 3).astype(np.float32)}
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        pl, = exe.run(pmain, feed=feed, fetch_list=[ploss], scope=scope)
        assert abs(float(pl) - float(np.asarray(jl))) <= TOL * max(
            abs(float(np.asarray(jl))), 1e-3)
    for n in params:
        w = np.asarray(jscope[n])
        assert not np.array_equal(w, init[n]), n
        np.testing.assert_allclose(scope[n].numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("cls,args", [("GradClipByValue", (-0.1, 0.2)),
                                      ("GradClipByNorm", (0.5,)),
                                      ("GradClipByGlobalNorm", (0.7,))])
def test_grad_clip_on_tensors_matches_jax(cls, args):
    grads = [np.random.default_rng(i).normal(size=(3, 4)).astype(np.float32)
             for i in range(3)]
    got = getattr(pclip, cls)(*args)(
        [("p%d" % i, torch.from_numpy(g)) for i, g in enumerate(grads)]
        + [("none", None)])
    want = getattr(jclip, cls)(*args)(
        [("p%d" % i, jnp.asarray(g)) for i, g in enumerate(grads)]
        + [("none", None)])
    assert got[-1] == ("none", None) and want[-1] == ("none", None)
    for (pn, a), (wn, w) in zip(got[:-1], want[:-1]):
        assert pn == wn
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL * float(np.abs(w).max()))
    assert pclip.GradClipByNorm is fluid.clip.GradClipByNorm


def test_grad_clip_must_be_a_grad_clip():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = fluid.layers.mean(fluid.layers.fc(fluid.data("x", [None, 2]),
                                                 1))
        with pytest.raises(TypeError, match="GradClipBase"):
            fluid.optimizer.SGD(0.1).minimize(loss, grad_clip=1.0)


# ---------------------------------------------------------------------------
# the LAMB recipe's Program
# ---------------------------------------------------------------------------
def lamb_recipe(fl, bert_mod, cfg, seq, recompute=True):
    """BERT pretraining under the LAMB recipe: Lamb (weight decay 0.01,
    none on biases and LayerNorm), linear warmup over 10 steps into
    polynomial decay from 1e-4 over 1000, a global-norm clip at 1.0, and
    RecomputeOptimizer over each encoder layer's output; returns (io, lr
    var)."""
    io = bert_mod.build_bert_pretrain(cfg, seq)
    main = fl.default_main_program()
    lr = fl.layers.linear_lr_warmup(
        fl.layers.polynomial_decay(1e-4, decay_steps=1000,
                                   end_learning_rate=0.0),
        warmup_steps=10, start_lr=0.0, end_lr=1e-4)
    fl.clip.set_gradient_clip(fl.clip.GradientClipByGlobalNorm(1.0))
    opt = fl.optimizer.Lamb(
        learning_rate=lr, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=lambda p: (p.name.endswith(".b")
                                                or "ln" in p.name))
    if recompute:
        opt = fl.optimizer.RecomputeOptimizer(opt)
        ys = {op.input("Scale")[0]: op.output("Y")[0]
              for op in main.global_block().ops if op.type == "layer_norm"}
        opt._set_checkpoints([ys["enc_l%d_ln2.w" % i]
                              for i in range(cfg.num_layers)])
    opt.minimize(io["loss"])
    return io, lr


def test_lamb_recipe_program_parity():
    seq = 16
    jmain, jstart, _ = _build(jfluid, jax_unique_name, lambda fl: lamb_recipe(
        fl, jbert, jbert.bert_tiny(seq), seq))
    pmain, pstart, _ = _build(fluid, pt_unique_name, lambda fl: lamb_recipe(
        fl, bert, bert.bert_tiny(seq), seq))
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    ops = [op.type for op in pmain.global_block().ops]
    assert ops[0] == "increment"
    assert {"lamb", "squared_l2_norm", "sum", "sqrt", "elementwise_pow",
            "backward"} <= set(ops)
    bw = pmain.global_block().ops[ops.index("backward")]
    assert len(bw.attrs["checkpoints"]) == 2
    # no weight decay on biases and LayerNorm parameters
    for op in pmain.global_block().ops:
        if op.type == "lamb":
            p = op.input("Param")[0]
            assert (op.attrs["weight_decay"] == 0.0) == (
                p.endswith(".b") or "ln" in p), p
