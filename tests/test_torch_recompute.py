"""Recompute, several backward ops in one block, and autograd through
control flow: the port's ``_run_training`` against the JAX package, on
the CPU.

- The LAMB recipe for BERT (Lamb, warmup + polynomial decay, global-norm
  clip, RecomputeOptimizer over each layer's output) on bert_tiny, 5
  steps in both packages from the JAX startup's parameters, dropout 0:
  losses within 1e-4 relative, every step's gradients within
  1e-4·max|grad| of each parameter's, the learning rate within 1e-6
  relative, and each parameter's 5-step update within 1e-2·max|update|
  everywhere and 1e-3·max|update| on 99% of its elements (the trust
  ratio scales every element alike, and where a gradient stays near
  LAMB's eps, m/sqrt(v) passes the packages' rounding differences on
  nearly undamped, as in tests/test_torch_train.py's Adam test).
- Recompute against no recompute on bert_tiny with dropout 0.1 (the
  elementwise dropout and the attention kernel's dropout seed), 3 steps:
  losses, gradients and every persistable value bit-identical, each
  wrapped segment replayed once a step; a replay that does not restore
  the generators draws other masks and changes the gradients.
- tests/test_gradients_pyfunc.py's ``test_gradients_of_gradients`` and
  ``test_recompute_with_intermediate_gradients`` built and run in both
  packages: the same Program JSON, fetches within 1e-5 relative; a GAN's
  two ``minimize`` calls (two backward ops, each over its own
  parameters) trained 3 steps in both; a var in the ``no_grad`` set of
  one backward op but not of the other.
- ``static_rnn``, ``cond`` (IfElse) and ``conditional_block`` (Switch)
  programs with parameters read inside their sub-blocks, trained 3 SGD
  steps in both packages: losses within 1e-5 relative, parameters within
  1e-5·max|param|. A ``While`` whose carried value holds a gradient
  raises in both.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.registry import LowerContext
from test_torch_lr_clip import lamb_recipe

SEQ = 16
TOL = 1e-5


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
    startup.random_seed = 7
    with fl.program_guard(main, startup):
        out = fn(fl)
    return main, startup, out


def _both(fn):
    """fn built in both packages (same Program JSON); the JAX startup run,
    its persistables copied into a port scope. Returns (jmain, jexe,
    jscope, jout, pmain, exe, scope, pout)."""
    jmain, jstart, jout = _build(jfluid, jax_unique_name, fn)
    pmain, pstart, pout = _build(fluid, pt_unique_name, fn)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.array(jscope[v.name])
            for v in pmain.global_block().vars.values()
            if v.persistable and v.name in jscope}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    return jmain, jexe, jscope, jout, pmain, exe, scope, pout


def _close(a, w, what, tol=TOL):
    a, w = np.asarray(a, np.float32), np.asarray(w, np.float32)
    assert a.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(a - w).max()) <= tol * scale, what


def _names(out):
    return [v.name if hasattr(v, "name") else v for v in out]


# ---------------------------------------------------------------------------
# the LAMB recipe on bert_tiny
# ---------------------------------------------------------------------------
def test_lamb_recipe_bert_tiny_matches_jax():
    def fn(fl):
        bm = jbert if fl is jfluid else bert
        io, lr = lamb_recipe(fl, bm, bm.bert_tiny(SEQ), SEQ)
        return [io["loss"], lr]

    jmain, jexe, jscope, jout, pmain, exe, scope, pout = _both(fn)
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    init = {n: scope[n].numpy().copy() for n in params}
    ids, labels = bert.synthetic_batch(bert.bert_tiny(SEQ), 2, SEQ, seed=3)
    feed = {"input_ids": ids, "mlm_labels": labels}
    for step in range(5):
        j = jexe.run(jmain, feed=feed, fetch_list=_names(jout) + grads,
                     scope=jscope)
        p = exe.run(pmain, feed=feed, fetch_list=_names(pout) + grads,
                    scope=scope)
        jl, pl = float(np.asarray(j[0])), float(p[0])
        assert abs(pl - jl) <= 1e-4 * abs(jl), (step, pl, jl)
        np.testing.assert_allclose(p[1], np.asarray(j[1]), rtol=1e-6,
                                   atol=1e-12)
        for name, a, w in zip(grads, p[2:], j[2:]):
            _close(a, w, (step, name), tol=1e-4)
    for n in params:
        moved = scope[n].numpy() - init[n]
        want = np.asarray(jscope[n]) - init[n]
        scale = float(np.abs(want).max())
        assert scale > 0, n
        off = np.abs(moved - want)
        assert float(off.max()) <= 1e-2 * scale, n
        assert float((off <= 1e-3 * scale).mean()) >= 0.99, n


# ---------------------------------------------------------------------------
# recompute against none, with dropout
# ---------------------------------------------------------------------------
def _dropout_run(recompute, steps=3):
    cfg = bert.bert_tiny(SEQ)
    cfg.dropout = 0.1
    main, startup, (io, lr) = _build(
        fluid, pt_unique_name,
        lambda fl: lamb_recipe(fl, bert, cfg, SEQ, recompute=recompute))
    main.random_seed = 5
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    exe = fluid.Executor(fluid.CPUPlace())
    ids, labels = bert.synthetic_batch(cfg, 4, SEQ, seed=3)
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters())
    out = [exe.run(main, feed={"input_ids": ids, "mlm_labels": labels},
                   fetch_list=[io["loss"]] + grads, scope=scope)
           for _ in range(steps)]
    return out, {n: scope[n].clone() for n in scope.keys()}


def test_recompute_bit_identical_with_dropout(monkeypatch):
    replays = []
    set_states = LowerContext.set_rng_states

    def counted(self, states):
        replays.append(states)
        set_states(self, states)

    want, wstate = _dropout_run(False)
    assert not replays
    monkeypatch.setattr(LowerContext, "set_rng_states", counted)
    got, gstate = _dropout_run(True)
    # 2 wrapped segments (each layer's output is a cut, the MLM head after
    # the last one is not wrapped) replayed once a step; each replay sets
    # the generators and puts them back
    assert len(replays) == 2 * 2 * 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert wstate.keys() == gstate.keys()
    for n in wstate:
        assert torch.equal(wstate[n], gstate[n]), n
    # a replay that leaves the generators where the first pass left them
    # draws other dropout masks: the gradients come out wrong
    monkeypatch.setattr(LowerContext, "set_rng_states",
                        lambda self, states: None)
    bad, _ = _dropout_run(True, steps=1)
    assert bad[0][0] == want[0][0]              # the forward is the same
    assert any(not np.array_equal(a, b) for a, b in zip(bad[0][1:],
                                                        want[0][1:]))


# ---------------------------------------------------------------------------
# several backward ops in a block
# ---------------------------------------------------------------------------
def _grad_of_grad(fl):
    """tests/test_gradients_pyfunc.py::test_gradients_of_gradients."""
    x = fl.data(name="x", shape=[3], dtype="float32")
    w = fl.layers.create_parameter([3], "float32", name="ggw")
    h = fl.layers.elementwise_mul(x, w)
    loss = fl.layers.reduce_sum(fl.layers.square(h))
    (g_h,) = fl.gradients(loss, h)
    meta = fl.layers.reduce_sum(fl.layers.square(g_h))
    (g_g,) = fl.gradients(meta, g_h)
    return [g_g, h, g_h, meta]


def _recompute_intermediate(fl):
    """tests/test_gradients_pyfunc.py::
    test_recompute_with_intermediate_gradients."""
    x = fl.data(name="x", shape=[4, 8], dtype="float32")
    h1 = fl.layers.fc(x, size=8, act="relu",
                      param_attr=fl.ParamAttr(name="rc_w1"))
    h2 = fl.layers.fc(h1, size=8, act="relu",
                      param_attr=fl.ParamAttr(name="rc_w2"))
    pred = fl.layers.fc(h2, size=1, param_attr=fl.ParamAttr(name="rc_w3"))
    loss = fl.layers.reduce_mean(fl.layers.square(pred))
    (g_h1,) = fl.gradients(loss, h1)
    meta = fl.layers.reduce_sum(fl.layers.square(g_h1))
    opt = fl.optimizer.RecomputeOptimizer(fl.optimizer.SGD(learning_rate=0.01))
    opt._set_checkpoints([h1, h2])
    opt.minimize(loss)
    return [g_h1, meta, loss]


def _gan(fl):
    """Two minimize calls, each over its own parameters: the
    discriminator's loss first, then the generator's, read through the
    discriminator the first minimize has just updated."""
    z = fl.data("z", [None, 4], dtype="float32")
    real = fl.data("real", [None, 6], dtype="float32")
    fake = fl.layers.fc(z, 6, act="sigmoid",
                        param_attr=fl.ParamAttr(name="gen.w"),
                        bias_attr=fl.ParamAttr(name="gen.b"))

    def disc(v):
        return fl.layers.fc(v, 1, param_attr=fl.ParamAttr(name="disc.w"),
                            bias_attr=fl.ParamAttr(name="disc.b"))

    d_loss = fl.layers.mean(fl.layers.elementwise_sub(
        fl.layers.square(disc(fake)), disc(real)))
    main = fl.default_main_program()
    fl.optimizer.SGD(0.1).minimize(d_loss, parameter_list=[
        main.global_block().var(n) for n in ("disc.w", "disc.b")])
    g_loss = fl.layers.mean(fl.layers.scale(disc(fake), scale=-1.0))
    fl.optimizer.SGD(0.1).minimize(g_loss, parameter_list=[
        main.global_block().var(n) for n in ("gen.w", "gen.b")])
    return [d_loss, g_loss]


def _no_grad_for_one(fl):
    """d loss/d h, then d loss/d w1 with h in the no_grad set: zeros."""
    x = fl.data("x", [None, 5], dtype="float32")
    h = fl.layers.fc(x, 4, act="relu", param_attr=fl.ParamAttr(name="ng.w1"))
    loss = fl.layers.mean(fl.layers.fc(h, 2, param_attr=fl.ParamAttr(
        name="ng.w2")))
    (g_h,) = fl.gradients(loss, h)
    main = fl.default_main_program()
    w1, w2 = (main.global_block().var(n) for n in ("ng.w1", "ng.w2"))
    g_w1, g_w2 = fl.gradients(loss, [w1, w2], no_grad_set=[h])
    return [g_h, g_w1, g_w2, loss]


MULTI = {
    "gradients_of_gradients": (_grad_of_grad, lambda r: {
        "x": np.array([1.0, -2.0, 3.0], np.float32)}, 1),
    "recompute_with_intermediate_gradients": (
        _recompute_intermediate, lambda r: {
            "x": r.random((4, 8)).astype(np.float32)}, 3),
    "gan_two_minimize": (_gan, lambda r: {
        "z": r.normal(size=(5, 4)).astype(np.float32),
        "real": r.normal(size=(5, 6)).astype(np.float32)}, 3),
    "no_grad_for_one_backward": (_no_grad_for_one, lambda r: {
        "x": r.normal(size=(3, 5)).astype(np.float32)}, 1),
}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_several_backward_ops_match_jax(name):
    fn, feed, steps = MULTI[name]
    jmain, jexe, jscope, jout, pmain, exe, scope, pout = _both(fn)
    assert sum(op.type == "backward" for op in pmain.global_block().ops) == 2
    rng = np.random.default_rng(0)
    for _ in range(steps):
        f = feed(rng)
        got = exe.run(pmain, feed=f, fetch_list=pout, scope=scope)
        want = jexe.run(jmain, feed=f, fetch_list=jout, scope=jscope)
        for v, a, w in zip(pout, got, want):
            _close(a, w, v.name)
    if name == "gradients_of_gradients":
        np.testing.assert_allclose(got[0], 4.0 * got[1], rtol=1e-5)
    if name == "no_grad_for_one_backward":
        assert np.abs(got[0]).max() > 0
        assert not got[1].any() and got[2].any()
    for p in pmain.all_parameters():
        _close(scope[p.name].numpy(), jscope[p.name], p.name)


# ---------------------------------------------------------------------------
# autograd through control flow
# ---------------------------------------------------------------------------
def _static_rnn_train(fl):
    L = fl.layers
    x = fl.data("xs", [5, -1, 3], dtype="float32")
    h0 = fl.data("h0", [-1, 4], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = L.elementwise_add(
            L.fc(xt, 4, param_attr=fl.ParamAttr(name="rnn.wx"),
                 bias_attr=fl.ParamAttr(name="rnn.b")),
            L.fc(h_prev, 4, param_attr=fl.ParamAttr(name="rnn.wh"),
                 bias_attr=False), act="relu")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    loss = L.mean(L.elementwise_mul(rnn(), rnn()))
    fl.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def _cond_train(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    n = fl.data("n", [1], dtype="float32")
    y = L.fc(x, 4, param_attr=fl.ParamAttr(name="c.w0"))
    ie = L.IfElse(L.less_than(n, L.fill_constant([1], "float32", 2.0)))
    with ie.true_block():
        ie.output(L.fc(ie.input(y), 2, param_attr=fl.ParamAttr(name="c.wt")))
    with ie.false_block():
        ie.output(L.scale(L.fc(ie.input(y), 2, act="relu",
                               param_attr=fl.ParamAttr(name="c.wf")), 3.0))
    loss = L.mean(L.elementwise_mul(ie()[0], ie()[0]))
    fl.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def _switch_train(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    n = fl.data("n", [1], dtype="float32")
    y = L.fc(x, 4, param_attr=fl.ParamAttr(name="s.w0"))
    out = L.scale(y, scale=0.0)
    sw = L.Switch()
    with sw.case(L.less_than(n, L.fill_constant([1], "float32", 1.0))):
        L.assign(L.scale(y, scale=2.0), out)
    with sw.default():
        L.assign(L.elementwise_mul(y, y), out)
    loss = L.mean(out)
    fl.optimizer.SGD(0.1).minimize(loss)
    return [loss]


_X = np.random.default_rng(9).normal(size=(2, 3)).astype(np.float32)
FLOWS = {
    "static_rnn": (_static_rnn_train, [
        {"xs": np.random.default_rng(3).normal(size=(5, 2, 3)).astype(
            np.float32),
         "h0": np.random.default_rng(4).normal(size=(2, 4)).astype(
             np.float32)}] * 3),
    "cond": (_cond_train, [{"x": _X, "n": np.array([v], np.float32)}
                           for v in (1.0, 3.0, 1.0)]),
    "conditional_block": (_switch_train, [
        {"x": _X, "n": np.array([v], np.float32)} for v in (0.0, 2.0, 0.0)]),
}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_control_flow_trains_like_jax(name):
    fn, feeds = FLOWS[name]
    jmain, jexe, jscope, jout, pmain, exe, scope, pout = _both(fn)
    params = [p.name for p in pmain.all_parameters()]
    init = {n: scope[n].clone() for n in params}
    for f in feeds:
        got, = exe.run(pmain, feed=f, fetch_list=pout, scope=scope)
        want, = jexe.run(jmain, feed=f, fetch_list=jout, scope=jscope)
        assert abs(float(got) - float(np.asarray(want))) <= TOL * abs(
            float(np.asarray(want))), name
    for n in params:
        assert not torch.equal(scope[n], init[n]), n     # every one trained
        _close(scope[n].numpy(), jscope[n], n)


def _while_train(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    acc = L.fc(x, 3)
    i = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 2.0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.scale(acc, scale=0.5), acc)
        L.increment(i)
        L.less_than(i, n, cond=cond)
    loss = L.mean(acc)
    fl.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def test_backward_through_while_raises_in_both():
    jmain, jexe, jscope, jout, pmain, exe, scope, pout = _both(_while_train)
    with warnings.catch_warnings(), pytest.raises(
            ValueError, match="Reverse-mode differentiation does not work "
                              "for lax.while_loop"):
        warnings.simplefilter("ignore")     # the executor's AOT fallback
        jexe.run(jmain, feed={"x": _X}, fetch_list=jout, scope=jscope)
    with pytest.raises(NotImplementedError,
                       match="cannot differentiate 'while' either"):
        exe.run(pmain, feed={"x": _X}, fetch_list=pout, scope=scope)


def test_lookup_table_gradient_is_deterministic_on_the_cpu():
    """The embedding's gradient sums a repeated id's rows in one order:
    the indexing backward (index_put_ with accumulate) summed them in
    another order on every multi-threaded CPU run, so recompute could not
    be told from the run without it, bit for bit, at BERT widths."""
    from paddle_tpu_torch.ops.registry import get_lowering

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 500, (8, 128)))
    w0 = torch.from_numpy(rng.normal(size=(500, 64)).astype(np.float32))
    seed = torch.from_numpy(rng.normal(size=(8, 128, 64)).astype(np.float32))
    got = []
    for _ in range(8):
        w = w0.clone().requires_grad_()
        out = get_lowering("lookup_table_v2")(
            LowerContext(torch.device("cpu")), {"W": [w], "Ids": [ids]},
            {})["Out"][0]
        got.append(torch.autograd.grad(out, [w], seed)[0])
    for g in got[1:]:
        assert torch.equal(g, got[0])
